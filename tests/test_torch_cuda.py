"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode.  This file imports neither JAX nor the JAX package, so it
runs on a machine without them, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: attention atol = rtol = 2e-2
(bf16 output; the kernel's fp32 sums run in another order); dense+GELU
codes equal but for at most 0.5% of entries, which differ by exactly 1
(tanhf / expf differ from PyTorch's in the last fp32 bit), scales within
rtol 1e-5.  The prologue kernels: the norm statistics are fp32 sums in
another order, which can move a code by one, so the mlp_in codes take the
dense+GELU bound and the qkv outputs agree to one bf16 ulp (rtol 2^-7) on
all but 0.5% (a moved code shifts its whole row by w/127 of a column,
and so the mlp_in row's scale, by up to ~1e-3: rtol 2e-3 there); the
fused W8A8 product is bit-equal (no sum before the exact product).
The DAC transposes (B7, B8): max abs error <= 1e-3 * max |plain| (the
same bf16 products with fp32 sums in another order, and ``sinf`` against
PyTorch's ``sin``, which can move one bf16 input by one ulp); the residual
units (B9, B6) 4e-3, as ``chip_smoke.py`` states: a sum in another order
moves some of their bf16 intermediates by one ulp, ~1e-3 of an output
each (1.08e-3 measured at stage 2's B6).  The fused decode on the card
against the CPU: max abs 5e-3, the fp32 decode bound of
``tests/test_dac.py``.  The training attention (B10): forward atol = rtol =
2e-2 as the serving attention; backward max abs <= 1e-2 x max |plain| per
gradient (bf16 outputs, and ds rounds to bf16 before its products, so a sum
in another order moves some ds by one ulp: measured 4.3e-3 x max at the
v3 shape; where dq and dk vanish in exact arithmetic, at N = 1 without
dropout, both versions stay below the fp32 rounding of the two sums whose
difference ds is), and two runs of the forward and of the backward are
bit-equal (no atomics).  The narrow trainable DiT's step on the card
against the CPU: loss rtol 1e-2, grad
norm rtol 2e-2, updated parameters within 2 lr (a first Adam step moves
each by +-lr, so a gradient whose sign differs in bf16 moves it the other
way) and within 2 % of lr on average.
The s8 product on a pre-quantised A (B14, the s8 ``wgmma`` GEMM on the
weight K-major) is bit-equal to its plain version in bf16 and fp32 output,
and ``w8a8_dot(impl="pallas")`` (its row-quant launch, then B14) to
``impl="xla"``; B12's GEMM stage alone is bit-equal to the ``_int_mm``
chain on the same codes.  B5 and B13 read their weights K-major
(``w_t``, ``w1_t``, ``w2_t``), raise on the card without them, and give the
same bits on two calls.  The whole MLP (B13) rounds at the same
points as its plain version; tanhf / expf may differ from PyTorch's in the
last bit and move a bf16 g, and so a code, by one: at most 0.1 % of the
outputs differ, each within 0.02 absolute plus 0.02 relative (the bound of
the CPU test against the JAX kernel).  The fused out projection (B12): the
kernel's fp32 sums run in another order, which can move a normalised weight
or a head's output by one bf16 ulp and so a code of the row quantisation by
one; max abs error <= 1e-2 x max |plain|.  The split q/k/v attention
kernels (B11, B15, B16): atol = rtol = 2e-2, as the other attention kernels;
B15 and B16 bit-equal to each other.  B2 and B11 (one body) are each
bit-equal on their two grids, and B2 is bit-equal to B11 on PyTorch's bf16
RoPE of q and k where N % 8 == 0 and no key is masked.
Audio in, audio out: the production codec's encoder and RVQ on the card
against the CPU within ``tests/test_dac.py``'s bounds against the torch
mirror (z_e 3e-4 x max, at most 2 % of the codes); the resample within
2e-6 (one fp32 conv); ``python -m jatsr_torch.cli.infer`` at ``tiny`` on
the card against ``--platform cpu`` on the same (CPU-drawn) noise within
relative L2 5e-2, the bound of the port's pipeline against JAX's
(measured 1.1e-2).
Training entry point: the tiny ``Trainer`` on the card (dropout 0.1, the
native loader) resumed from its `last` ends bit-equal to two epochs
straight, and each remat policy's gradients are bit-equal to "none"'s on
the card (the kernels and cuBLAS give the same bits on the same inputs),
with B10's forward launched once a block under "none" and twice under the
others.
The split entries of tensor parallelism (B1, B5, B4: ``ops/split.py``)
over two ranks, threads on one card joined by a fake model group: the
shares joined bit-equal to the whole-width kernel (the row maxima and the
int32 partial products are exact in any order), B4's pieces (row maxima,
codes, int32 products) bit-equal to their plain versions.
"""

import math

import numpy as np
import pytest
import torch

from jatsr_torch.models.dit import rope_cos_sin
from jatsr_torch.ops import attention_train as at
from jatsr_torch.ops import dac_kernels as dk
from jatsr_torch.ops.attention import (_flash_out_lib, flash_out_plain,
                                       flash_out_weight_t, flash_qkv_plain,
                                       flash_split_plain, gqa_attention,
                                       gqa_attention_flash,
                                       gqa_attention_flash_out,
                                       gqa_attention_flash_qkv,
                                       gqa_attention_grouped,
                                       gqa_attention_plain)
from jatsr_torch.ops.int8_matmul import (_INV127, dense_gelu_quant_plain,
                                         int8_dense_gelu_quant, int8_matmul,
                                         int8_matmul_fused, int8_mlp,
                                         int8_mm, int8_quantize_rows,
                                         matmul_fused_plain,
                                         matmul_prequant_plain, mlp_plain,
                                         quantize_rows)
from jatsr_torch.ops.prologue import (_prologue_plain,
                                      int8_norm_mod_dense_gelu_quant,
                                      int8_norm_mod_dot,
                                      norm_mod_dense_gelu_quant_plain,
                                      norm_mod_dot_plain, s8_dot,
                                      s8_dot_plain, s8_gelu_quant,
                                      s8_gelu_quant_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n_valid", [0, 300])
def test_flash_qkv_kernel_matches_plain(card, n_valid):
    gen = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn((6, 345, 1792), generator=gen, device=card).bfloat16()
    cos, sin = rope_cos_sin(345, 64, device=card)
    n0 = gqa_attention_flash_qkv.launches
    got = gqa_attention_flash_qkv(qkv, cos, sin, 20, 4, n_valid=n_valid)
    assert gqa_attention_flash_qkv.launches == n0 + 1
    want = flash_qkv_plain(qkv, cos, sin, 20, 4, n_valid=n_valid)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_qkv_kernel_small_odd_shape(card):
    gen = torch.Generator(device=card).manual_seed(2)
    qkv = torch.randn((2, 90, 12 * 64), generator=gen, device=card).bfloat16()
    cos, sin = rope_cos_sin(90, 64, device=card)
    got = gqa_attention_flash_qkv(qkv, cos, sin, 8, 2)
    want = flash_qkv_plain(qkv, cos, sin, 8, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _dense_inputs(card, M, K, N, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device=card).bfloat16()
    w_q = torch.randint(-127, 128, (K, N), generator=gen, device=card,
                        dtype=torch.int8)
    w_s = torch.rand((1, N), generator=gen, device=card) \
        .add_(0.5).div_(127 * K ** 0.5)
    b = 0.1 * torch.randn((1, N), generator=gen, device=card)
    return a, w_q, w_s, b


def _assert_codes(got, want, scale_rtol=1e-5):
    diff = (got[0].int() - want[0].int()).abs()
    assert diff.max().item() <= 1
    assert (diff != 0).float().mean().item() <= 0.005
    torch.testing.assert_close(got[1], want[1], rtol=scale_rtol, atol=0)


@pytest.mark.parametrize("M,K,N", [(2070, 1280, 5120), (2070, 8192, 512)])
def test_dense_gelu_quant_kernel_matches_plain(card, M, K, N):
    args = _dense_inputs(card, M, K, N, seed=3)
    n0 = int8_dense_gelu_quant.launches
    got = int8_dense_gelu_quant(*args, w_t=args[1].t().contiguous())
    assert int8_dense_gelu_quant.launches == n0 + 1
    _assert_codes(got, dense_gelu_quant_plain(*args))


@pytest.mark.parametrize("gelu_impl", ["tanh", "erf", "sigmoid"])
@pytest.mark.parametrize("fast_epilogue", [True, False])
def test_dense_gelu_quant_kernel_epilogues(card, gelu_impl, fast_epilogue):
    args = _dense_inputs(card, 100, 256, 512, seed=4)
    got = int8_dense_gelu_quant(*args, gelu_impl=gelu_impl,
                                fast_epilogue=fast_epilogue,
                                w_t=args[1].t().contiguous())
    _assert_codes(got, dense_gelu_quant_plain(*args, gelu_impl=gelu_impl,
                                              fast_epilogue=fast_epilogue))


@pytest.mark.parametrize("fast_epilogue", [True, False])
@pytest.mark.parametrize("M,K,N", [(2070, 1280, 5120), (2112, 8192, 512)])
def test_dense_gelu_quant_kernel_at_the_path_shapes(card, M, K, N,
                                                    fast_epilogue):
    """B5 at mlp_in (the second and split-attention paths) and the patch
    embed (every path), in both epilogue modes: the codes within the
    dense+GELU bound, and two calls bit-equal (no atomics)."""
    args = _dense_inputs(card, M, K, N, seed=5)
    w_t = args[1].t().contiguous()
    got = int8_dense_gelu_quant(*args, fast_epilogue=fast_epilogue, w_t=w_t)
    _assert_codes(got, dense_gelu_quant_plain(*args,
                                              fast_epilogue=fast_epilogue))
    again = int8_dense_gelu_quant(*args, fast_epilogue=fast_epilogue, w_t=w_t)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_dense_gelu_quant_kernel_raises_without_its_kmajor_copy(card):
    args = _dense_inputs(card, 100, 256, 512, seed=6)
    with pytest.raises(ValueError, match="w_t"):
        int8_dense_gelu_quant(*args)


def _prologue_inputs(card, B, Np, H, N, rows, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = (2 * torch.randn((B, Np, H), generator=gen, device=card)
         + 0.3).bfloat16()
    mod = 0.5 * torch.randn((2, B if rows == "per_sample" else 1, H),
                            generator=gen, device=card)
    sc, sh = mod.bfloat16().float()
    _, w_q, w_s, b = _dense_inputs(card, 1, H, N, seed + 1)
    return x, sc, sh, w_q, w_s, b


def _assert_bf16_rows(got, want):
    got, want = got.float(), want.float()
    far = (got - want).abs() > want.abs() * 2.0 ** -7
    assert far.float().mean().item() <= 0.005


SHAPES = pytest.mark.parametrize("B,Np,H,N", [(6, 352, 1280, 1792),
                                              (3, 40, 128, 256),
                                              (2, 37, 1280, 1792)])
ROWS = pytest.mark.parametrize("rows", ["per_sample", "shared"])


@SHAPES
@ROWS
@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norm_mod_dot_kernel_matches_plain(card, B, Np, H, N, rows, norm):
    args = _prologue_inputs(card, B, Np, H, N, rows, seed=7)
    n0 = int8_norm_mod_dot.launches
    got = int8_norm_mod_dot(*args, norm=norm, w_t=args[3].t().contiguous())
    assert int8_norm_mod_dot.launches == n0 + 1
    _assert_bf16_rows(got, norm_mod_dot_plain(*args, norm=norm))


@pytest.mark.parametrize("B,Np,H", [(6, 352, 1280), (3, 40, 128),
                                    (2, 37, 1280)])
@ROWS
def test_norm_mod_dense_gelu_quant_kernel_matches_plain(card, B, Np, H, rows):
    args = _prologue_inputs(card, B, Np, H, 4 * H, rows, seed=8)
    n0 = int8_norm_mod_dense_gelu_quant.launches
    got_q, got_s = int8_norm_mod_dense_gelu_quant(
        *args, norm="rms", w_t=args[3].t().contiguous())
    assert int8_norm_mod_dense_gelu_quant.launches == n0 + 1
    want_q, want_s = norm_mod_dense_gelu_quant_plain(*args, norm="rms")
    _assert_codes((got_q.reshape(B * Np, -1), got_s.reshape(-1, 1)),
                  (want_q.reshape(B * Np, -1), want_s.reshape(-1, 1)),
                  scale_rtol=2e-3)


@pytest.mark.parametrize("gelu_impl", ["tanh", "erf", "sigmoid"])
@pytest.mark.parametrize("B,Np,H,N", [(6, 352, 1280, 1792),
                                      (2, 37, 1280, 1792), (3, 40, 128, 256)])
def test_prologue_gemms_are_bit_equal_to_the_plain_epilogue(card, B, Np, H, N,
                                                            gelu_impl):
    """B3's and B1's s8 wgmma GEMMs alone (``s8_dot``, ``s8_gelu_quant``:
    the prologue skipped) on the plain prologue's codes and scales: B3's
    bf16 outputs, B1's codes and row scales bit-equal to the plain
    epilogue's (an exact int32 product, then the same fp32 operations in
    the same order; B1's GELU at N = 4 H), at M = 2112, 74 and 120."""
    x, sc, sh, w_q, w_s, b = _prologue_inputs(card, B, Np, H, N, "per_sample",
                                              seed=11)
    a_q, s = _prologue_plain(x, sc, sh, "layer")
    assert torch.equal(s8_dot(a_q, s, w_q.t().contiguous(), w_s, b),
                       s8_dot_plain(a_q, s, w_q, w_s, b))
    _, w_q, w_s, b = _dense_inputs(card, 1, H, 4 * H, seed=12)
    got = s8_gelu_quant(a_q, s, w_q.t().contiguous(), w_s, b, gelu_impl)
    want = s8_gelu_quant_plain(a_q, s, w_q, w_s, b, gelu_impl)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("M,K,N", [(2112, 1280, 1280), (100, 256, 384)])
def test_matmul_fused_kernel_matches_plain(card, M, K, N):
    """B4 (the row quant, then the s8 wgmma GEMM on the K-major weight) bit
    for bit, with an all-zero row (the floored scale) and a row whose one
    large value sets its scale; on the card it raises without ``w_t``."""
    a, w_q, w_s, _ = _dense_inputs(card, M, K, N, seed=9)
    a[3] = 0.0
    a[5, 7] = 3.0e4
    n0 = int8_matmul_fused.launches
    got = int8_matmul_fused(a, w_q, w_s, w_t=w_q.t().contiguous())
    assert int8_matmul_fused.launches == n0 + 1
    want = matmul_fused_plain(a, w_q, w_s)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    with pytest.raises(ValueError, match="w_t"):
        int8_matmul_fused(a, w_q, w_s)


@pytest.mark.parametrize("a_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_matmul_fused_kernel_other_dtypes_match_plain(card, a_dtype,
                                                      out_dtype):
    """B4's fp32 mode (the row quant on fp32 rows, the GEMM's fp32
    instance) at the out_proj shape and past K = 2048 (the row read twice),
    bit for bit, with an all-zero row and one large value; fp16 raises."""
    for M, K, N in ((2112, 1280, 1280), (100, 4096, 384)):
        a, w_q, w_s, _ = _dense_inputs(card, M, K, N, seed=9)
        a = (a.float() + 1e-3 * torch.randn_like(a.float())).to(a_dtype)
        a[3] = 0.0
        a[5, 7] = 3.0e4
        w_t = w_q.t().contiguous()
        n0 = int8_matmul_fused.launches
        got = int8_matmul_fused(a, w_q, w_s, out_dtype=out_dtype, w_t=w_t)
        assert int8_matmul_fused.launches == n0 + 1
        want = matmul_fused_plain(a, w_q, w_s, out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want)
    with pytest.raises(TypeError, match="float16"):
        int8_matmul_fused(a.half(), w_q, w_s, w_t=w_t)


def test_w8a8_dot_fused_fp32_lhs_on_card(card):
    """``w8a8_dot(impl="fused")`` with an fp32 lhs launches B4 and returns
    fp32, equal to ``impl="xla"`` bit for bit."""
    from jatsr_torch.ops.quant import w8a8_dot

    a, w_q, w_s, _ = _dense_inputs(card, 2 * 352, 1280, 1280, seed=10)
    x = a.float().reshape(2, 352, 1280)
    n0 = int8_matmul_fused.launches
    got = w8a8_dot(x, w_q, w_s, impl="fused", w_t=w_q.t().contiguous())
    assert int8_matmul_fused.launches == n0 + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, w8a8_dot(x, w_q, w_s, impl="xla"))


def test_w8a8_dot_fused_equals_xla_on_card(card):
    """``impl="fused"`` launches the fused kernel and equals the two-stage
    ``impl="xla"`` path bit for bit (the JAX package's
    ``test_fused_matches_two_stage``)."""
    from jatsr_torch.ops.quant import w8a8_dot

    a, w_q, w_s, _ = _dense_inputs(card, 2 * 352, 1280, 1280, seed=10)
    x = a.reshape(2, 352, 1280)
    n0 = int8_matmul_fused.launches
    got = w8a8_dot(x, w_q, w_s, impl="fused", w_t=w_q.t().contiguous())
    assert int8_matmul_fused.launches == n0 + 1
    torch.testing.assert_close(got, w8a8_dot(x, w_q, w_s, impl="xla"),
                               atol=0, rtol=0)


@pytest.mark.parametrize("knobs", [
    {}, {"fused_prologue": True, "align_n": True},
    {"int8_impl": "fused"},
    {"fused_prologue": True, "align_n": True, "flash_fused_out": True,
     "fused_mlp_impl": "full", "int8_impl": "pallas"},
    {"fused_prologue": True, "align_n": True, "flash_qkv": False},
    {"attention_impl": "pallas"}, {"attention_impl": "pallas2"},
    {"fused_prologue": True, "align_n": True, "fused_qkv": False,
     "int8_impl": "pallas"},
    {"fused_mlp": False, "int8_impl": "fused"},
    {"quantize_head": True, "fused_mlp": False},
    {"fused_prologue": True, "align_n": True, "pos_embed": "learned",
     "attention_bias": True, "num_kv_heads": 4},
    {"fused_prologue": True, "align_n": True, "flash_int8_qk": True}])
def test_narrow_dit_on_card_matches_cpu(card, knobs):
    """A narrow int8 DiT (head dim 64, as the kernel needs) on the card
    against the same weights on the CPU's plain path, without and with the
    fused prologue (130 frames: 33 patches, aligned to 40), with the
    three opt-in kernels (B12, B13, B14) in place of the prologue, on
    the split q/k/v through B11, B15 and B16 (33 patches), and on the
    branches past those: q/k/v projections apart through B14, the unfused
    QuantDense MLP through B4, the int8 head, learned positions at G = 1
    (B11), and B2's s8 value product behind the fused prologue."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    cfg = dataclasses.replace(get_preset("tiny").model, **{
        **dict(hidden_size=256, num_q_heads=4, num_kv_heads=2,
               bottleneck_dim=128, input_channels=64, cond_channels=64,
               matmul_precision="int8_static", fused_qkv=True,
               fused_mlp=True, attention_impl="flash"), **knobs})
    static = quantize_params_static(random_dense_params(cfg, 5), cfg)
    rng = np.random.default_rng(6)
    x_t, x_c = (torch.from_numpy(rng.standard_normal((2, 130, 64),
                                                     dtype=np.float32))
                for _ in range(2))
    t = torch.tensor([0.2, 0.9])
    ref = DiT(cfg, static, device="cpu")(x_t, t, x_c)
    out = DiT(cfg, static, device="cuda")(x_t.cuda(), t.cuda(),
                                          x_c.cuda()).cpu()
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 2e-2


def test_dit_out_projection_reads_its_kmajor_copy(card, monkeypatch):
    """The fused-prologue DiT on the card hands B4 the K-major copy of
    out_proj's kernel that it made at construction (the very tensor, no
    copy a call), and launches B4 once a block; the weights' buffers do not
    grow with the calls."""
    import dataclasses

    import jatsr_torch.models.dit as tdit
    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    cfg = dataclasses.replace(
        get_preset("tiny").model, hidden_size=256, num_q_heads=4,
        num_kv_heads=2, bottleneck_dim=128, input_channels=64,
        cond_channels=64, matmul_precision="int8_static", fused_qkv=True,
        fused_mlp=True, attention_impl="flash", fused_prologue=True,
        align_n=True)
    model = tdit.DiT(cfg, quantize_params_static(random_dense_params(cfg, 5),
                                                 cfg), device="cuda")
    seen, fn = [], tdit.int8_matmul_fused

    def spy(*a, **kw):
        seen.append(kw["w_t"].data_ptr())
        return fn(*a, **kw)

    monkeypatch.setattr(tdit, "int8_matmul_fused", spy)
    x_t, x_c = (torch.randn((2, 130, 64), device=card) for _ in range(2))
    t = torch.tensor([0.2, 0.9], device=card)
    n0 = int8_matmul_fused.launches
    model(x_t, t, x_c)
    torch.cuda.synchronize()
    assert int8_matmul_fused.launches - n0 == cfg.depth
    assert seen == [b.attn.out_kernel_t.data_ptr() for b in model.blocks]
    buffers = sum(b.numel() for b in model.buffers())
    model(x_t, t, x_c)
    assert sum(b.numel() for b in model.buffers()) == buffers


@pytest.mark.parametrize("M,K,N", [(2112, 1280, 1792), (100, 256, 384)])
def test_int8_matmul_kernel_bit_equal_to_plain_and_xla(card, M, K, N):
    """B14 at the qkv shape, and a small one, on the weight K-major;
    ``w8a8_dot(impl="pallas")`` launches it and equals ``impl="xla"`` bit
    for bit."""
    from jatsr_torch.ops.quant import w8a8_dot

    a, w_q, w_s, _ = _dense_inputs(card, M, K, N, seed=21)
    w_t = w_q.t().contiguous()
    a_q, a_s = quantize_rows(a)
    n0 = int8_matmul.launches
    got = int8_matmul(a_q, a_s, w_q, w_s, w_t=w_t)
    assert int8_matmul.launches == n0 + 1
    torch.testing.assert_close(got, matmul_prequant_plain(a_q, a_s, w_q, w_s),
                               atol=0, rtol=0)
    torch.testing.assert_close(w8a8_dot(a, w_q, w_s, impl="pallas", w_t=w_t),
                               w8a8_dot(a, w_q, w_s, impl="xla"),
                               atol=0, rtol=0)
    assert int8_matmul.launches == n0 + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [1792, 1280, 384])
@pytest.mark.parametrize("M", [2112, 2070, 33])
def test_int8_matmul_kernel_at_the_listed_shapes(card, M, N, dtype):
    """B14 bit-equal to its plain version at K = 1280, in bf16 and fp32
    output, with an all-zero row; two runs give the same bits."""
    a, w_q, w_s, _ = _dense_inputs(card, M, 1280, N, seed=M + N)
    a[1] = 0.0
    a_q, a_s = quantize_rows(a)
    w_t = w_q.t().contiguous()
    got = int8_matmul(a_q, a_s, w_q, w_s, out_dtype=dtype, w_t=w_t)
    assert got.dtype == dtype and got.shape == (M, N)
    want = matmul_prequant_plain(a_q, a_s, w_q, w_s, dtype)
    assert torch.equal(got, want)
    assert torch.equal(got, int8_matmul(a_q, a_s, w_q, w_s, out_dtype=dtype,
                                        w_t=w_t))


def test_int8_matmul_kernel_raises_without_its_kmajor_copy(card):
    """On the card B14 reads the weight K-major and raises without it, and
    writes bf16 or fp32 only."""
    a, w_q, w_s, _ = _dense_inputs(card, 64, 256, 384, seed=22)
    a_q, a_s = quantize_rows(a)
    with pytest.raises(ValueError, match="K-major"):
        int8_matmul(a_q, a_s, w_q, w_s)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        int8_matmul(a_q, a_s, w_q, w_s, out_dtype=torch.float16,
                    w_t=w_q.t().contiguous())


def _tiny_rows(a):
    """``a`` with row 3 all zero and row 5 scaled so that max|a| / 127 is
    below 1e-12: there the floored and unfloored scales differ."""
    a[3] = 0.0
    a[5] *= 1e-12
    return a


@pytest.mark.parametrize("lead,K,N", [((2, 352), 1280, 1792),
                                      ((2112,), 1280, 1280),
                                      ((40,), 256, 384)])
def test_w8a8_dot_pallas_equals_xla_on_card(card, lead, K, N):
    """``impl="pallas"`` on the card: one row-quant launch for a bf16 lhs,
    then B14, bit-equal to ``impl="xla"``, with an all-zero row and a row
    below the scale floor; an fp32 lhs keeps the torch quantisation and B14
    writes fp32, bit-equal too."""
    from jatsr_torch.ops.quant import w8a8_dot

    a, w_q, w_s, _ = _dense_inputs(card, int(np.prod(lead)), K, N, seed=K + N)
    x = _tiny_rows(a).reshape(*lead, K)
    assert (x.reshape(-1, K)[5].float().abs().max() / 127).item() < 1e-12
    w_t = w_q.t().contiguous()
    n0, q0 = int8_matmul.launches, int8_quantize_rows.launches
    got = w8a8_dot(x, w_q, w_s, impl="pallas", w_t=w_t)
    assert (int8_matmul.launches - n0, int8_quantize_rows.launches - q0) == (
        1, 1)
    want = w8a8_dot(x, w_q, w_s, impl="xla")
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, N)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert got.reshape(-1, N)[5].abs().max().item() > 0
    xf = x.float()
    got = w8a8_dot(xf, w_q, w_s, impl="pallas", w_t=w_t)
    assert got.dtype == torch.float32
    assert torch.equal(got, w8a8_dot(xf, w_q, w_s, impl="xla"))
    assert int8_quantize_rows.launches - q0 == 1


@pytest.mark.parametrize("M,K", [(2112, 1280), (100, 4096), (70, 5120),
                                 (33, 10240)])
def test_int8_quantize_rows_kernel_bit_equal_to_plain(card, M, K):
    """The row quant in front of B14 at each of its forms (a warp a row up
    to K = 4096, a CTA a row up to 8192, two reads past it): the codes by
    the floored scale and the unfloored scale, bit-equal to
    ``quantize_rows``."""
    a = _tiny_rows(_dense_inputs(card, M, K, 128, seed=K)[0])
    got_q, got_s = int8_quantize_rows(a)
    want_q, want_s = quantize_rows(a)
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    assert got_s[3].item() == 0.0 and 0 < got_s[5].item() < 1e-12


def _mlp_args(card, M, H, N1, seed):
    a, w1q, w1s, b1 = _dense_inputs(card, M, H, N1, seed)
    _, w2q, w2s, b2 = _dense_inputs(card, 1, N1, H, seed + 1)
    return a, w1q, w1s, b1, w2q, w2s, b2


def _mlp_t(args):
    """The K-major copies of both weights, as the DiT keeps them."""
    return {"w1_t": args[1].t().contiguous(), "w2_t": args[4].t().contiguous()}


@pytest.mark.parametrize("M,H,N1,gelu_impl", [
    (2112, 1280, 5120, "tanh"), (96, 128, 2560, "erf"),
    (100, 256, 1024, "sigmoid"), (70, 256, 384, "erf")])
def test_int8_mlp_kernel_matches_plain(card, M, H, N1, gelu_impl):
    """B13 at the v3 block (four slabs), two slabs, one, and one slab of
    three column tiles (one in shared memory, one in each warpgroup's
    registers)."""
    args = _mlp_args(card, M, H, N1, seed=22)
    n0 = int8_mlp.launches
    got = int8_mlp(*args, gelu_impl=gelu_impl, **_mlp_t(args)).float()
    assert int8_mlp.launches == n0 + 1
    want = mlp_plain(*args, gelu_impl=gelu_impl).float()
    assert (got != want).float().mean().item() <= 1e-3
    torch.testing.assert_close(got, want, atol=0.02, rtol=0.02)


@pytest.mark.parametrize("gelu_impl", ["tanh", "erf", "sigmoid"])
@pytest.mark.parametrize("M", [2070, 100])
def test_int8_mlp_kernel_at_v3_width_every_gelu(card, M, gelu_impl):
    """B13 at v3's widths (H 1280, four slabs of 1280) with M past a
    multiple of 64 (2070: the second path's rows; 100), in each GELU: the
    bound above, and two calls bit-equal (no atomics)."""
    args = _mlp_args(card, M, 1280, 5120, seed=23)
    kt = _mlp_t(args)
    got = int8_mlp(*args, gelu_impl=gelu_impl, **kt)
    want = mlp_plain(*args, gelu_impl=gelu_impl).float()
    assert (got.float() != want).float().mean().item() <= 1e-3
    torch.testing.assert_close(got.float(), want, atol=0.02, rtol=0.02)
    assert torch.equal(got, int8_mlp(*args, gelu_impl=gelu_impl, **kt))


def test_int8_mlp_kernel_raises_without_its_kmajor_copies(card):
    args = _mlp_args(card, 100, 256, 1024, seed=24)
    kt = _mlp_t(args)
    for missing in ("w1_t", "w2_t"):
        with pytest.raises(ValueError, match="K-major"):
            int8_mlp(*args, **{k: v for k, v in kt.items() if k != missing})


@pytest.mark.parametrize("B,N,n_valid,hq,hkv,H", [
    (6, 352, 345, 20, 4, 1280), (2, 90, 0, 8, 2, 256)])
def test_flash_out_kernel_matches_plain(card, B, N, n_valid, hq, hkv, H):
    """B12 at the serving shape (keys masked past 345) and a small one,
    with a non-zero bias, on the out projection's weight K-major."""
    gen = torch.Generator(device=card).manual_seed(23)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * 64), generator=gen,
                      device=card).bfloat16()
    cos, sin = rope_cos_sin(N, 64, device=card)
    _, wo_q, wo_s, bo = _dense_inputs(card, 1, hq * 64, H, seed=24)
    n0 = gqa_attention_flash_out.launches
    got = gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                                  n_valid=n_valid,
                                  wo_t=flash_out_weight_t(wo_q, hq, 64)).float()
    assert gqa_attention_flash_out.launches == n0 + 1
    want = flash_out_plain(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                           n_valid=n_valid).float()
    _assert_rel(got, want, 1e-2)
    with pytest.raises(ValueError, match="K-major"):
        gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv)


@pytest.mark.parametrize("D", [32, 48, 64, 128, 256])
def test_flash_out_kernel_at_v3_heads_every_head_dim(card, D):
    """B12 at v3's heads (20/4), 352 patches with keys masked past 345 and
    a 1280-wide out projection, at head dims 32, 48 (zero-padded to the 64
    instance, the DiT's padded K-major weight), 64, 128 and 256 (the wide
    kernels): within 1e-2 x max |plain|."""
    B, N, hq, hkv, H = 6, 352, 20, 4, 1280
    qkv, cos, sin = _qkv_inputs(card, B, N, hq, hkv, D, seed=110 + D)
    _, wo_q, wo_s, bo = _dense_inputs(card, 1, hq * D, H, seed=111 + D)
    wo_t = flash_out_weight_t(wo_q, hq, D)
    got = gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                                  n_valid=N - 7, wo_t=wo_t).float()
    want = flash_out_plain(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                           n_valid=N - 7).float()
    assert torch.isfinite(got).all()
    _assert_rel(got, want, 1e-2)


@pytest.mark.parametrize("M,K,H", [(2112, 1280, 1280), (2070, 2560, 384),
                                   (90, 64, 256), (33, 5120, 1280)])
def test_flash_out_gemm_stage_bit_equal_to_the_int_mm_chain(card, M, K, H):
    """B12's GEMM stage alone (``flash_out_gemm``: the s8 wgmma GEMM with
    the dequant and bias epilogue) on given codes and scales: bit-equal to
    ``bf16(((float)(o_q @ wo) * so) * wos + bo)`` by ``_int_mm`` and fp32
    torch ops (on the CPU, which takes any K); K = 64 is less than one
    stage (the TMA boxes zero-fill past K)."""
    from jatsr_torch.ops import _build

    o, wo_q, wo_s, bo = _dense_inputs(card, M, K, H, seed=M + K)
    o_q, so = quantize_rows(o)
    so = so.clamp_min(1e-12)
    wos, b = wo_s.reshape(H).contiguous(), bo.reshape(H).contiguous()
    wo_t = wo_q.t().contiguous()
    out = torch.empty((M, H), dtype=torch.bfloat16, device=card)
    lib = _flash_out_lib()
    err = lib.flash_out_gemm(o_q.data_ptr(), so.data_ptr(), wo_t.data_ptr(),
                             wos.data_ptr(), b.data_ptr(), out.data_ptr(), M,
                             K, H, _build.stream_ptr(card))
    _build.check(lib, err, "flash_out_gemm")
    acc = int8_mm(o_q.cpu(), wo_q.cpu()).float()
    want = (acc * so.cpu() * wos.cpu() + b.cpu()).bfloat16()
    assert torch.equal(out.cpu().view(torch.int16), want.view(torch.int16))


def test_opt_in_dit_hands_its_kernels_their_kmajor_copies(card, monkeypatch):
    """The third path's DiT on the card (flash_fused_out, the whole MLP,
    int8_impl "pallas"): B14 reads qkv_proj's K-major kernel, which is the
    DiT's qkv_kernel_t (one copy), and B12 the out_kernel_t made at
    construction, each launched once a block, no copy a call."""
    import dataclasses

    import jatsr_torch.models.dit as tdit
    import jatsr_torch.ops.quant as tquant
    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    cfg = dataclasses.replace(
        get_preset("tiny").model, hidden_size=256, num_q_heads=4,
        num_kv_heads=2, bottleneck_dim=128, input_channels=64,
        cond_channels=64, matmul_precision="int8_static", fused_qkv=True,
        fused_mlp=True, attention_impl="flash", fused_prologue=True,
        align_n=True, flash_fused_out=True, fused_mlp_impl="full",
        int8_impl="pallas")
    model = tdit.DiT(cfg, quantize_params_static(random_dense_params(cfg, 5),
                                                 cfg), device="cuda")
    seen = {"qkv": [], "out": []}
    mm, fo = tquant.int8_matmul, tdit.gqa_attention_flash_out

    def spy_mm(*a, **kw):
        seen["qkv"].append(kw["w_t"].data_ptr())
        return mm(*a, **kw)

    def spy_fo(*a, **kw):
        seen["out"].append(kw["wo_t"].data_ptr())
        return fo(*a, **kw)

    monkeypatch.setattr(tquant, "int8_matmul", spy_mm)
    monkeypatch.setattr(tdit, "gqa_attention_flash_out", spy_fo)
    x_t, x_c = (torch.randn((2, 130, 64), device=card) for _ in range(2))
    t = torch.tensor([0.2, 0.9], device=card)
    n0 = (int8_matmul.launches, gqa_attention_flash_out.launches)
    model(x_t, t, x_c)
    torch.cuda.synchronize()
    assert (int8_matmul.launches - n0[0],
            gqa_attention_flash_out.launches - n0[1]) == (cfg.depth,) * 2
    blocks = model.blocks
    assert seen["qkv"] == [b.attn.qkv_kernel_t.data_ptr() for b in blocks]
    assert all(b.attn.qkv_kernel_t is b.attn.qkv_proj.kernel_t
               for b in blocks)
    assert seen["out"] == [b.attn.out_kernel_t.data_ptr() for b in blocks]


def _split_inputs(card, B, N, hq, hkv, seed, D=64):
    """q, k and v as column slices of one fused [B, N, (hq + 2 hkv) * D]
    projection, as the split branch hands them over (k and v strided)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * D), generator=gen,
                      device=card).bfloat16()
    return (qkv[..., :hq * D].contiguous(),
            qkv[..., hq * D:(hq + hkv) * D], qkv[..., (hq + hkv) * D:])


@pytest.mark.parametrize("B,N,hq,hkv", [(6, 345, 20, 4), (2, 90, 8, 2),
                                        (1, 64, 4, 4), (6, 345, 12, 12)])
def test_split_attention_kernels_match_plain(card, B, N, hq, hkv):
    """B11, B15 and B16 at the serving shape, a small padded one, an
    aligned one without grouping, and v1legacy's 12/12 heads at 345 (G =
    1); k and v strided views."""
    q, k, v = _split_inputs(card, B, N, hq, hkv, seed=25)
    n0 = (gqa_attention_flash.launches, gqa_attention.launches,
          gqa_attention_grouped.launches)
    got = gqa_attention_flash(q, k, v, hq, hkv)
    want = flash_split_plain(q, k, v, hq, hkv)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    q4, k4, v4 = (x.reshape(B, N, -1, 64) for x in (q, k, v))
    want = gqa_attention_plain(q4, k4, v4).float()
    a, b = gqa_attention(q4, k4, v4), gqa_attention_grouped(q4, k4, v4)
    assert a.shape == b.shape == (B, N, hq, 64)
    for got in (a, b):
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    assert (gqa_attention_flash.launches, gqa_attention.launches,
            gqa_attention_grouped.launches) == tuple(n + 1 for n in n0)


@pytest.mark.parametrize("B,N,hq,hkv", [(2, 90, 8, 2), (6, 345, 20, 4)])
def test_split_flash_kernel_keeps_the_padding_in_the_max(card, B, N, hq, hkv):
    """Every real score negative: the zero keys padding N = 90 to 96 (and
    the serving shape's 345 to 352) set the row max, in the kernel as in
    its plain version. v is about 1, so that every output is about 1 and
    leaving the zero keys' share in l (7 % of it at N = 345) puts every
    output about 2.8 times past the tolerance."""
    gen = torch.Generator(device=card).manual_seed(26)
    q = torch.randn((B, N, hq * 64), generator=gen, device=card).abs()
    k = -torch.randn((B, N, hkv * 64), generator=gen, device=card).abs()
    v = torch.randn((B, N, hkv * 64), generator=gen, device=card)
    q, k, v = (x.mul(0.5).bfloat16() for x in (q, k, v + 2))
    got = gqa_attention_flash(q, k, v, hq, hkv).float()
    torch.testing.assert_close(got, flash_split_plain(q, k, v, hq,
                                                      hkv).float(),
                               atol=2e-2, rtol=2e-2)


DEFERRED = [(2, N, 0, 10, 2) for N in (1, 17, 64, 65, 345, 513, 768)] + [
    (6, 352, 345, 20, 4)]


@pytest.mark.parametrize("B,N,n_valid,hq,hkv", DEFERRED)
def test_flash_deferred_kernels_match_plain_on_both_grids(card, B, N,
                                                          n_valid, hq, hkv):
    """B2 and B11 (one launch each, counted once) against their plain
    versions across the kernels' range of N (one and several key chunks,
    K and V resident or not), with k and v column-slice views; each
    bit-equal on the per-kv-head and the balanced grid (no row's arithmetic
    depends on the grid)."""
    from jatsr_torch.ops.attention import _flash_deferred

    gen = torch.Generator(device=card).manual_seed(31 + N)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * 64), generator=gen,
                      device=card).bfloat16()
    cos, sin = rope_cos_sin(N, 64, device=card)
    n0 = gqa_attention_flash_qkv.launches
    got = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv, n_valid=n_valid)
    assert gqa_attention_flash_qkv.launches == n0 + 1
    torch.testing.assert_close(
        got.float(), flash_qkv_plain(qkv, cos, sin, hq, hkv,
                                     n_valid=n_valid).float(),
        atol=2e-2, rtol=2e-2)
    q, k, v = (qkv[..., :hq * 64], qkv[..., hq * 64:(hq + hkv) * 64],
               qkv[..., (hq + hkv) * 64:])
    n0 = gqa_attention_flash.launches
    got_split = gqa_attention_flash(q, k, v, hq, hkv)
    assert gqa_attention_flash.launches == n0 + 1
    torch.testing.assert_close(
        got_split.float(), flash_split_plain(q, k, v, hq, hkv).float(),
        atol=2e-2, rtol=2e-2)
    for balanced in (False, True):
        assert torch.equal(got, _flash_deferred(
            q, k, v, hq, hkv, n_valid or N, cos, sin, balanced=balanced))
        assert torch.equal(got_split, _flash_deferred(
            q, k, v, hq, hkv, None, balanced=balanced))


def test_flash_qkv_equals_flash_split_on_roped_inputs(card):
    """B2 on the unsplit qkv [6, 352, 1792] (RoPE inside, no key masked)
    bit-equal to B11 on PyTorch's bf16 RoPE of q and k and on v: N % 8 == 0,
    so B11 has no zero keys, and the kernels' RoPE rounds each operation as
    PyTorch's does (an FMA contraction or a missed rounding of the tables
    would show here)."""
    from jatsr_torch.ops.attention import _rope

    B, N, hq, hkv = 6, 352, 20, 4
    gen = torch.Generator(device=card).manual_seed(32)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * 64), generator=gen,
                      device=card).bfloat16()
    cos, sin = rope_cos_sin(N, 64, device=card)
    heads = qkv.reshape(B, N, hq + 2 * hkv, 64)
    cb, sb = cos.bfloat16()[:, None], sin.bfloat16()[:, None]
    q = _rope(heads[:, :, :hq], cb, sb).reshape(B, N, hq * 64)
    k = _rope(heads[:, :, hq:hq + hkv], cb, sb).reshape(B, N, hkv * 64)
    v = qkv[..., (hq + hkv) * 64:]
    a = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv)
    b = gqa_attention_flash(q, k, v, hq, hkv)
    assert torch.equal(a, b), (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("G", [1, 2, 5])
@pytest.mark.parametrize("N", [1, 17, 64, 65, 345, 513, 768])
def test_natural_attention_kernels_match_plain_and_each_other(card, N, G):
    """B15 and B16 against their plain version across the kernel's range of
    N (one and several key chunks, K and V resident or not, B16's heads at
    once or in rounds), with v a column-slice view of the fused projection;
    and bit-equal to each other (no row's arithmetic depends on the grid)."""
    B, hkv = 2, 2
    q, k, v = _split_inputs(card, B, N, G * hkv, hkv, seed=27 + N + G)
    q4, k4, v4 = (x.reshape(B, N, -1, 64) for x in (q, k, v))
    assert not v4.is_contiguous()
    n0 = (gqa_attention.launches, gqa_attention_grouped.launches)
    a, b = gqa_attention(q4, k4, v4), gqa_attention_grouped(q4, k4, v4)
    assert (gqa_attention.launches, gqa_attention_grouped.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = gqa_attention_plain(q4, k4, v4).float()
    for got in (a, b):
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    assert torch.equal(a, b)


def test_natural_attention_kernels_with_scores_below_2_to_minus_100(card):
    """q scaled so that many e = exp(s - m) fall below 2^-100, where the
    kernels take their divide's slow form: still their plain version's
    result, and bit-equal to each other."""
    q, k, v = _split_inputs(card, 2, 345, 10, 2, seed=30)
    q4, k4, v4 = (x.reshape(2, 345, -1, 64) for x in (q, k, v))
    q4 = (q4.float() * 12).bfloat16()
    want = gqa_attention_plain(q4, k4, v4).float()
    a, b = gqa_attention(q4, k4, v4), gqa_attention_grouped(q4, k4, v4)
    for got in (a, b):
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("N", [1025, 1378, 2048])
def test_natural_attention_raises_past_its_largest_n(card, N):
    """Past 1024 keys (where both grids raised before the streaming mode):
    N = 1025, 1378 (a 16 s chunk unpatchified) and 2048 at v3's heads, K
    and V through shared memory in 128-key chunks.  Both grids launch, match
    their plain version and are bit-equal to each other."""
    q, k, v = (x.reshape(2, N, -1, 64)
               for x in _split_inputs(card, 2, N, 20, 4, seed=28))
    n0 = (gqa_attention.launches, gqa_attention_grouped.launches)
    a, b = gqa_attention(q, k, v), gqa_attention_grouped(q, k, v)
    assert (gqa_attention.launches, gqa_attention_grouped.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = gqa_attention_plain(q, k, v).float()
    for got in (a, b):
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    assert torch.equal(a, b)


def test_natural_attention_divide_is_the_rounded_quotient(card):
    """The kernel's divide (an inline rcp_rn(l), Markstein's correction, a
    scaled form below e = 2^-100) bit-equal to __fdiv_rn: on 2^24 pairs, e
    in (0, 1] (uniform, and log-uniform down to 2^-149) and l in [1, 768];
    and for every fp32 l in [1, 768], at e = 1 and at a uniform e."""
    from jatsr_torch.ops.attention import natural_divide

    n = 1 << 24
    gen = torch.Generator(device=card).manual_seed(29)
    u = torch.rand(n, generator=gen, device=card)
    e = torch.where(torch.arange(n, device=card) % 2 == 0, 1.0 - u,
                    torch.exp2(-149.0 * u))
    l = 1.0 + 767.0 * torch.rand(n, generator=gen, device=card)
    fast, ref = natural_divide(e, l)
    assert torch.equal(fast.view(torch.int32), ref.view(torch.int32))
    lo, hi = (torch.tensor(x, dtype=torch.float32).view(torch.int32).item()
              for x in (1.0, 768.0))
    l = torch.arange(lo, hi + 1, device=card, dtype=torch.int32).view(
        torch.float32)
    for e in (torch.ones_like(l), 1.0 - torch.rand(l.shape, generator=gen,
                                                   device=card)):
        fast, ref = natural_divide(e, l)
        assert torch.equal(fast.view(torch.int32), ref.view(torch.int32))


def _assert_rel(got, want, rel=1e-3):
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


def _dac_unit_inputs(card, B, T, C, units, seed):
    """x ~ N(0, 1); weights as the DAC initializer draws them (uniform
    +-1/sqrt(fan_in)); biases N(0, 0.1^2); snake alphas in [0.5, 1.5)."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def uni(shape, lim):
        return (torch.rand(shape, generator=gen, device=card) * 2 - 1) * lim

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=card) * scale

    return (normal((B, T, C), 1.0), uni((units, 7, C, C), (7 * C) ** -0.5),
            normal((units, C), 0.1), uni((units, C, C), C ** -0.5),
            normal((units, C), 0.1),
            torch.rand((units, C), generator=gen, device=card) + 0.5,
            torch.rand((units, C), generator=gen, device=card) + 0.5)


@pytest.mark.parametrize("B,T,C,d", [(2, 1001, 96, 3), (1, 1024, 192, 9)])
def test_res_unit_kernel_matches_plain(card, B, T, C, d):
    x, w7, b7, w1, b1, a1, a2 = _dac_unit_inputs(card, B, T, C, 1, seed=11)
    n0 = dk.res_unit_fused.launches
    got = dk.res_unit_fused(x, w7[0], b7[0], w1[0], b1[0], a1[0], a2[0],
                            dilation=d)
    assert dk.res_unit_fused.launches == n0 + 1
    _assert_rel(got, dk.res_unit_plain(x, w7[0], b7[0], w1[0], b1[0], a1[0],
                                       a2[0], d), 4e-3)


@pytest.mark.parametrize("B,T,C", [(2, 777, 96), (2, 1001, 192),
                                   (2, 333, 384), (2, 130, 136),
                                   (1, 184576, 384), (1, 738304, 192),
                                   (1, 1476608, 96)])
def test_res_stage_kernel_matches_plain(card, B, T, C):
    """B = 2 at an odd T for each column tile (96 and 192; C 384 in two
    halves; C 136 a partial tile and a partial last k-block), and the
    decode's three stage shapes (one 2884-frame segment)."""
    args = _dac_unit_inputs(card, B, T, C, 3, seed=12)
    n0 = dk.res_stage_fused.launches
    got = dk.res_stage_fused(*args)
    assert dk.res_stage_fused.launches == n0 + 1
    _assert_rel(got, dk.res_stage_plain(*args), 4e-3)


def test_res_batched_snake_is_snake_bit_for_bit(card):
    """B6's snakes run in batches of branch-free sines (sinf's fast path,
    the same operations; the rare argument at or past 105615 by sinf
    itself): bit-equal to snake() on 2^24 x of every magnitude and sign
    (random bit patterns, NaN and infinities among them) and on 2^22 x
    around the fast path's edge, at alphas in [0.5, 1.5); NaN as NaN."""
    gen = torch.Generator(device=card).manual_seed(17)
    n = 1 << 24
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                         device=card, dtype=torch.int32)
    edge = (105615.0 * (0.5 + torch.rand(1 << 22, generator=gen,
                                         device=card)))
    for x in (bits.view(torch.float32), edge):
        a = torch.rand(x.shape, generator=gen, device=card) + 0.5
        got, ref = dk.snake_check(x, a)
        same = (got.view(torch.int32) == ref.view(torch.int32)) | (
            torch.isnan(got) & torch.isnan(ref))
        assert bool(same.all()), (x[~same][:4], got[~same][:4],
                                  ref[~same][:4])


def _tr_inputs(card, B, T, ci, co, s, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((B, T, ci), generator=gen, device=card)
    w = (torch.rand((2 * s, ci, co), generator=gen, device=card) * 2 - 1) \
        * (2 * s * ci) ** -0.5
    b = 0.1 * torch.randn((co,), generator=gen, device=card)
    a = torch.rand((ci,), generator=gen, device=card) + 0.5
    return x, w, b, a


@pytest.mark.parametrize("B,T,ci,co,s", [(2, 101, 192, 96, 2),
                                         (2, 100, 384, 192, 4),
                                         (1, 23072, 768, 384, 8)])
def test_snake_conv_transpose_kernel_matches_plain(card, B, T, ci, co, s):
    x, w, b, a = _tr_inputs(card, B, T, ci, co, s, seed=13)
    kw = dict(stride=s, padding=(s + 1) // 2, output_padding=s % 2)
    n0 = dk.snake_conv_transpose_fused.launches
    got = dk.snake_conv_transpose_fused(x, w, b, a, **kw)
    assert dk.snake_conv_transpose_fused.launches == n0 + 1
    _assert_rel(got, dk.snake_conv_transpose_plain(x, w, b, a, **kw))


@pytest.mark.parametrize("ci,co,s", [(768, 384, 8), (384, 192, 4),
                                    (192, 96, 2)])
@pytest.mark.parametrize("T", [129, 1000])
def test_snake_conv_transpose_kernel_at_the_stage_shapes(card, ci, co, s, T):
    """B7 at the decode's three stage widths, batch 2: T = 129 (a tile and
    the row t = T alone, the tile boundary inside the halo) and T = 1000
    (eight tiles, the last partial); both batch elements' first rows read
    the zero row t = -1."""
    x, w, b, a = _tr_inputs(card, 2, T, ci, co, s, seed=17)
    kw = dict(stride=s, padding=(s + 1) // 2, output_padding=s % 2)
    n0 = dk.snake_conv_transpose_fused.launches
    got = dk.snake_conv_transpose_fused(x, w, b, a, **kw)
    assert dk.snake_conv_transpose_fused.launches == n0 + 1
    _assert_rel(got, dk.snake_conv_transpose_plain(x, w, b, a, **kw))


@pytest.mark.parametrize("ci,co,s,T", [(768, 384, 8, 3000),
                                       (384, 192, 4, 5000),
                                       (192, 96, 2, 20000)])
def test_snake_conv_transpose_kernel_is_deterministic(card, ci, co, s, T):
    """Two runs of B7 give the same bits (no atomics, one sum order)."""
    x, w, b, a = _tr_inputs(card, 1, T, ci, co, s, seed=18)
    kw = dict(stride=s, padding=(s + 1) // 2, output_padding=s % 2)
    one = dk.snake_conv_transpose_fused(x, w, b, a, **kw)
    two = dk.snake_conv_transpose_fused(x, w, b, a, **kw)
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))


@pytest.mark.parametrize("B,T,ci,co,s", [(2, 77, 1024, 200, 4),
                                         (1, 2884, 1536, 768, 8),
                                         (3, 300, 1536, 768, 8)])
def test_snake_conv_transpose_streamed_kernel_matches_plain(card, B, T, ci,
                                                            co, s):
    """B8's wgmma kernel: Cout 200 (a partial column tile) at one partial
    row tile, stage 0 at one decode segment, and three batch elements whose
    T + 1 = 301 rows end inside a row tile."""
    x, w, b, a = _tr_inputs(card, B, T, ci, co, s, seed=14)
    kw = dict(stride=s, padding=(s + 1) // 2, output_padding=s % 2)
    n0 = dk.snake_conv_transpose_streamed.launches
    got = dk.snake_conv_transpose_streamed(x, w, b, a, **kw)
    assert dk.snake_conv_transpose_streamed.launches == n0 + 1
    _assert_rel(got, dk.snake_conv_transpose_plain(x, w, b, a, **kw))


def test_fused_decode_on_card_matches_cpu(card):
    """The full-width fused decoder at 172 frames (B8 once, B7 and B6
    three times each) on the card against its plain path on the CPU."""
    from jatsr_torch.models.dac import DAC, DACConfig
    from jatsr_torch.models.dac.model import init_decoder_params

    cfg = DACConfig()
    dec = init_decoder_params(cfg, seed=15)
    z = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (1, 172, cfg.latent_dim)).astype(np.float32))
    counters = (dk.snake_conv_transpose_streamed,
                dk.snake_conv_transpose_fused, dk.res_stage_fused,
                dk.res_unit_fused)
    n0 = [f.launches for f in counters]
    got = DAC(dec, cfg, fused_res_units=True, device="cuda").decode(
        z.cuda()).cpu()
    assert [f.launches - n for f, n in zip(counters, n0)] == [1, 3, 3, 0]
    want = DAC(dec, cfg, fused_res_units=True, device="cpu").decode(z)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-3


def _attn_train_inputs(card, B, N, hq, hkv, seed, D=64):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn((B, N, w * D), generator=gen, device=card).bfloat16()
            for w in (hq, hkv, hkv, hq)]


def _assert_grads(got, ref, q, k, v, do, hq, hkv, rate):
    """Each gradient within 1e-2 x max |plain|, but where it vanishes in
    exact arithmetic: at N = 1 without dropout p = 1 and o = v, so ds =
    scale (do v^T - rowsum(do o)) is the difference of two fp32 sums of the
    same D products (D <= 64), and dq and dk hold only their rounding, in
    both versions.  The products are exact; a sum of D of them with an
    accumulator that may truncate (the tensor cores') is off by at most D
    x 2u x sum |do v|, u = 2^-24, so there both must stay below scale x
    2^-15 x max sum |do v| (one bf16 rounding more each; scale = D^-1/2),
    times max |k| (dq) or G x max |q| (dk, a sum over the G q-heads)."""
    B, N, QD = q.shape
    G, D = hq // hkv, QD // hq
    d = do.float().reshape(B, N, hkv, G, D)
    prods = (d * v.float().reshape(B, N, hkv, 1, D)).abs().sum(-1).max()
    ds_noise = D ** -0.5 * 2.0 ** -15 * prods.item() * (1 + 2.0 ** -7)
    vanish = N == 1 and rate == 0.0
    for name, g, r, other in zip(("dq", "dk", "dv"), got, ref,
                                 (k, G * q, None)):
        assert g.shape == r.shape
        if vanish and other is not None:
            bound = ds_noise * other.float().abs().max().item()
            for x in (g, r):
                assert x.float().abs().max().item() <= bound, (name, bound)
            continue
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 1e-2 * r.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, -123456789)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 4), (20, 4)])
@pytest.mark.parametrize("N", [1, 45, 128, 129, 345, 480])
def test_attention_train_kernels_match_plain(card, N, hq, hkv, rate, seed):
    """Batch 2 at every N and G (1, 2, 5), dropout 0 and 0.1; batch 28 at
    the v3 training shape (N 345, 20/4 heads)."""
    B = 28 if (N, hq) == (345, 20) else 2
    q, k, v, do = _attn_train_inputs(card, B, N, hq, hkv, 17)
    n0 = (at.attention_train_fwd.launches, at.attention_train_bwd.launches)
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    grads = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    assert (at.attention_train_fwd.launches,
            at.attention_train_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    _assert_grads(grads, at.attention_train_bwd_plain(
        q, k, v, o, do, seed, hq, hkv, rate), q, k, v, do, hq, hkv, rate)


def test_attention_train_backward_is_deterministic(card):
    """Two runs of the forward (output and row statistics) and of the
    backward are bit-equal: every sum runs in a fixed order, no atomics."""
    q, k, v, do = _attn_train_inputs(card, 28, 345, 20, 4, 18)
    o, stats = at.attention_train_fwd(q, k, v, 5, 20, 4, 0.1)
    o2, stats2 = at.attention_train_fwd(q, k, v, 5, 20, 4, 0.1)
    assert torch.equal(o, o2) and torch.equal(stats, stats2)
    a = at.attention_train_bwd(q, k, v, o, do, 5, 20, 4, 0.1, stats)
    b = at.attention_train_bwd(q, k, v, o, do, 5, 20, 4, 0.1, stats)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_narrow_dense_dit_step_on_card_matches_cpu(card):
    """One train step of a narrow trainable DiT (head dim 64, as B10 needs;
    remat "full"; 130 frames: 33 patches) on the card against the CPU on the
    same weights, batch and draws.  B10 runs twice per block forward (the
    remat replay) and once per block backward."""
    import dataclasses

    from jatsr_torch.configs import LossConfig, TrainConfig, get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(
        get_preset("tiny").model, hidden_size=256, num_q_heads=4,
        num_kv_heads=2, bottleneck_dim=128, input_channels=64,
        cond_channels=64)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, cfg_dropout_prob=0.2)
    dense = random_dense_params(cfg, 19)
    rng = np.random.default_rng(20)
    hr, lr = (torch.from_numpy(rng.standard_normal((4, 130, 64),
                                                   dtype=np.float32))
              for _ in range(2))
    draws = {"noise": rng.standard_normal((4, 130, 64), dtype=np.float32),
             "u": rng.random(4, dtype=np.float32),
             "cond_noise": rng.standard_normal((4, 130, 64), dtype=np.float32),
             "cfg_u": rng.random((4, 1, 1), dtype=np.float32),
             "layer_seeds": [3, 4]}
    ones = np.ones(64, np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        state = create_train_state(DenseDiT(cfg, dense, device=dev), tcfg,
                                   100, (hr, lr), device=dev)
        step = make_train_step(LossConfig(), tcfg,
                               Normalizer(0 * ones, ones, 0 * ones, ones,
                                          device=dev))
        n0 = (at.attention_train_fwd.launches,
              at.attention_train_bwd.launches)
        state, m = step(state, hr, lr, draws=draws)
        n1 = (at.attention_train_fwd.launches,
              at.attention_train_bwd.launches)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [p.detach().cpu() for p in state.params],
                    (n1[0] - n0[0], n1[1] - n0[1]))
    (m_c, p_c, l_c), (m_g, p_g, l_g) = out["cpu"], out["cuda"]
    assert l_c == (0, 0) and l_g == (2 * cfg.depth, cfg.depth)
    np.testing.assert_allclose(m_g["loss"], m_c["loss"], rtol=1e-2)
    np.testing.assert_allclose(m_g["grad_norm"], m_c["grad_norm"], rtol=2e-2)
    for a, b in zip(p_g, p_c):
        d = (a - b).abs()
        assert d.max().item() <= 2 * tcfg.lr * 1.01
        assert d.mean().item() <= 0.02 * tcfg.lr


# ---- head dims 16 and 32, and N past 768 ------------------------------------

def _qkv_inputs(card, B, N, hq, hkv, D, seed):
    """A fused [B, N, (hq + 2 hkv) * D] projection and its RoPE tables."""
    gen = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * D), generator=gen,
                      device=card).bfloat16()
    return (qkv, *rope_cos_sin(N, D, device=card))


def _serving_attention_cases(card, B, N, hq, hkv, D, n_valid, H, seed,
                             split_heads=None):
    """B2 (keys masked past n_valid), B11 and B12 (an int8 [hq D, H] out
    projection) on one fused projection, and B15 and B16 on the split views
    of ``split_heads`` (hq, hkv) heads (default the same), each launched
    once and counted, against their plain versions; B15 bit-equal to B16."""
    qkv, cos, sin = _qkv_inputs(card, B, N, hq, hkv, D, seed)
    counters = (gqa_attention_flash_qkv, gqa_attention_flash,
                gqa_attention_flash_out, gqa_attention, gqa_attention_grouped)
    n0 = [f.launches for f in counters]
    got = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv, n_valid=n_valid)
    torch.testing.assert_close(
        got.float(), flash_qkv_plain(qkv, cos, sin, hq, hkv,
                                     n_valid=n_valid).float(),
        atol=2e-2, rtol=2e-2)
    q, k, v = (qkv[..., :hq * D], qkv[..., hq * D:(hq + hkv) * D],
               qkv[..., (hq + hkv) * D:])
    got = gqa_attention_flash(q, k, v, hq, hkv)
    torch.testing.assert_close(
        got.float(), flash_split_plain(q, k, v, hq, hkv).float(),
        atol=2e-2, rtol=2e-2)
    _, wo_q, wo_s, bo = _dense_inputs(card, 1, hq * D, H, seed=seed + 1)
    got = gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                                  n_valid=n_valid,
                                  wo_t=flash_out_weight_t(wo_q, hq, D)
                                  ).float().cpu()
    # The plain version on the CPU: cuBLAS's int8 product (torch._int_mm)
    # refuses the 64-deep out projection of head dim 16 on the card.
    want = flash_out_plain(*(x.cpu() for x in (qkv, cos, sin, wo_q, wo_s,
                                               bo)), hq, hkv, n_valid=n_valid)
    _assert_rel(got, want.float(), 1e-2)
    shq, shkv = split_heads or (hq, hkv)
    q, k, v = (x.reshape(B, N, -1, D) for x in _split_inputs(
        card, B, N, shq, shkv, seed + 2, D))
    a, b = gqa_attention(q, k, v), gqa_attention_grouped(q, k, v)
    want = gqa_attention_plain(q, k, v).float()
    for x in (a, b):
        torch.testing.assert_close(x.float(), want, atol=2e-2, rtol=2e-2)
    assert torch.equal(a, b)
    assert [f.launches - n for f, n in zip(counters, n0)] == [1] * 5


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("N", [45, 345])
def test_serving_attention_kernels_at_head_dims_16_and_32(card, N, D):
    """B2, B11, B12, B15 and B16 at tiny's heads (4 q-heads, 2 kv-heads)
    with head dim 32 (tiny's) and 16 (the JAX kernel tests' smallest); keys
    masked past N - 5 for B2 and B12."""
    _serving_attention_cases(card, 2, N, 4, 2, D, N - 5, 128, seed=40 + D)


@pytest.mark.parametrize("N", [769, 864, 1000])
def test_serving_attention_kernels_past_768_keys(card, N):
    """B2, B11 and B12 at v1's heads (8/4, head dim 64, out projection 512
    wide) and B15 and B16 at v3's (20/4), at N past the 768 keys the
    kernels took before: seven or eight 128-key chunks, K and V no longer
    together in shared memory."""
    _serving_attention_cases(card, 2, N, 8, 4, 64, N - 3, 512, seed=N,
                             split_heads=(20, 4))


def test_bit_equalities_at_head_dim_32_past_768_keys(card):
    """At head dim 32 and N = 864 (tiny's heads): B15 bit-equal to B16, and
    B2 on the unsplit projection bit-equal to B11 on PyTorch's bf16 RoPE of
    q and k (N % 8 == 0: no zero keys; no key masked)."""
    from jatsr_torch.ops.attention import _rope

    B, N, hq, hkv, D = 2, 864, 4, 2, 32
    qkv, cos, sin = _qkv_inputs(card, B, N, hq, hkv, D, seed=50)
    heads = qkv.reshape(B, N, hq + 2 * hkv, D)
    cb, sb = cos.bfloat16()[:, None], sin.bfloat16()[:, None]
    q = _rope(heads[:, :, :hq], cb, sb)
    k = _rope(heads[:, :, hq:hq + hkv], cb, sb)
    v = heads[:, :, hq + hkv:]
    a = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv)
    b = gqa_attention_flash(q.reshape(B, N, -1), k.reshape(B, N, -1),
                            v.reshape(B, N, -1), hq, hkv)
    assert torch.equal(a, b), (a.float() - b.float()).abs().max().item()
    assert torch.equal(gqa_attention(q, k, v), gqa_attention_grouped(q, k, v))


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, -123456789)])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("N", [45, 345])
def test_attention_train_kernels_at_head_dims_16_and_32(card, N, D, rate,
                                                        seed):
    """B10 forward and backward at tiny's heads (4/2) with head dim 32 and
    16, against their plain versions (the tolerances of
    ``test_attention_train_kernels_match_plain``)."""
    hq, hkv = 4, 2
    q, k, v, do = _attn_train_inputs(card, 2, N, hq, hkv, 60 + D, D)
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    grads = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    _assert_grads(grads, at.attention_train_bwd_plain(
        q, k, v, o, do, seed, hq, hkv, rate), q, k, v, do, hq, hkv, rate)


@pytest.mark.parametrize("D", [16, 32])
def test_attention_train_is_deterministic_at_head_dims_16_and_32(card, D):
    """Two runs of B10's forward and backward bit-equal at head dim D."""
    q, k, v, do = _attn_train_inputs(card, 4, 345, 4, 2, 61, D)
    o, stats = at.attention_train_fwd(q, k, v, 5, 4, 2, 0.1)
    o2, stats2 = at.attention_train_fwd(q, k, v, 5, 4, 2, 0.1)
    assert torch.equal(o, o2) and torch.equal(stats, stats2)
    a = at.attention_train_bwd(q, k, v, o, do, 5, 4, 2, 0.1, stats)
    b = at.attention_train_bwd(q, k, v, o, do, 5, 4, 2, 0.1, stats)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("knob", ["bf16", "float32", "bf16_params"])
def test_tiny_train_step_on_card_matches_cpu(card, knob):
    """One train step of the tiny preset (head dim 32: B10 at D = 32; remat
    "full"; 130 frames, 33 patches) on the card against the CPU on the same
    weights, batch and draws, under the tolerances of
    ``test_narrow_dense_dit_step_on_card_matches_cpu``: as the preset
    trains it, at dtype="float32" (B10's fp32 mode) and at
    param_dtype="bfloat16" (bf16 parameters, gradients and second moment),
    where an updated parameter may also differ by one bf16 ulp of its value
    (its single rounding of p + u can land on either neighbour)."""
    import dataclasses

    from jatsr_torch.configs import LossConfig, TrainConfig, get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    kw = {"bf16": {}, "float32": {"dtype": "float32"},
          "bf16_params": {"param_dtype": "bfloat16"}}[knob]
    cfg = dataclasses.replace(get_preset("tiny").model, **kw)
    C = cfg.input_channels
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, cfg_dropout_prob=0.2)
    dense = random_dense_params(cfg, 22)
    rng = np.random.default_rng(23)
    hr, lr = (torch.from_numpy(rng.standard_normal((4, 130, C),
                                                   dtype=np.float32))
              for _ in range(2))
    draws = {"noise": rng.standard_normal((4, 130, C), dtype=np.float32),
             "u": rng.random(4, dtype=np.float32),
             "cond_noise": rng.standard_normal((4, 130, C), dtype=np.float32),
             "cfg_u": rng.random((4, 1, 1), dtype=np.float32),
             "layer_seeds": [3, 4]}
    ones = np.ones(C, np.float32)
    counts = (at.attention_train_fwd, at.attention_train_bwd)
    out = {}
    for dev in ("cpu", "cuda"):
        state = create_train_state(DenseDiT(cfg, dense, device=dev), tcfg,
                                   100, (hr, lr), device=dev)
        step = make_train_step(LossConfig(), tcfg,
                               Normalizer(0 * ones, ones, 0 * ones, ones,
                                          device=dev))
        n0 = [getattr(f, a) for f in counts
              for a in ("launches", "f32_launches")]
        state, m = step(state, hr, lr, draws=draws)
        n1 = [getattr(f, a) for f in counts
              for a in ("launches", "f32_launches")]
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [p.detach().cpu() for p in state.params],
                    tuple(b - a for a, b in zip(n0, n1)),
                    {str(p.dtype) for p in state.params})
    (m_c, p_c, l_c, t_c), (m_g, p_g, l_g, t_g) = out["cpu"], out["cuda"]
    f32 = knob == "float32"
    assert l_c == (0, 0, 0, 0)
    assert l_g == (2 * cfg.depth, 2 * cfg.depth if f32 else 0, cfg.depth,
                   cfg.depth if f32 else 0)
    assert t_c == t_g == {"torch.bfloat16" if knob == "bf16_params"
                          else "torch.float32"}
    np.testing.assert_allclose(m_g["loss"], m_c["loss"], rtol=1e-2)
    np.testing.assert_allclose(m_g["grad_norm"], m_c["grad_norm"], rtol=2e-2)
    for a, b in zip(p_g, p_c):
        a, b = a.float(), b.float()
        ulp = 2.0 ** -7 * b.abs() if knob == "bf16_params" else 0.0
        d = (a - b).abs()
        assert bool((d <= 2 * tcfg.lr * 1.01 + ulp).all())
        assert d.mean().item() <= 0.02 * tcfg.lr


@pytest.mark.parametrize("impl", ["flash", "pallas", "pallas2"])
def test_tiny_dense_dit_eval_forward_on_card_matches_cpu(card, impl):
    """The deterministic forward of the tiny trainable DiT (head dim 32)
    under ``attention_impl`` flash (B11), pallas (B15) and pallas2 (B16),
    one launch a block, on the card against the CPU on 45 patches: within
    2e-2 x the output's max, the bound of the eval path against JAX
    (``tests/test_torch_train_step.py``)."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params

    cfg = dataclasses.replace(get_preset("tiny").model, attention_impl=impl)
    counter = {"flash": gqa_attention_flash, "pallas": gqa_attention,
               "pallas2": gqa_attention_grouped}[impl]
    dense = random_dense_params(cfg, 24)
    rng = np.random.default_rng(25)
    x, c = (torch.from_numpy(rng.standard_normal(
        (2, 45 * 4, cfg.input_channels), dtype=np.float32)) for _ in range(2))
    t = torch.tensor([0.3, 0.8])
    with torch.no_grad():
        want = DenseDiT(cfg, dense, device="cpu")(x, t, c)
        n0 = counter.launches
        got = DenseDiT(cfg, dense, device="cuda")(x.cuda(), t.cuda(),
                                                  c.cuda()).cpu()
    assert counter.launches - n0 == cfg.depth
    scale = want.abs().max().item()
    assert torch.isfinite(got).all() and scale > 0.1
    assert (got - want).abs().max().item() <= 2e-2 * scale


# ---- head dims 24, 48 and 128 ----------------------------------------------

@pytest.mark.parametrize("D", [24, 48, 128])
@pytest.mark.parametrize("N", [45, 345])
def test_serving_attention_kernels_at_head_dims_24_48_and_128(card, N, D):
    """B2, B11, B12, B15 and B16 at tiny's heads (4/2) with head dim 24
    and 48 (zero-padded to the 32 and 64 instances: RoPE's halves kept
    apart, the true head dim's scale) and 128 (its own instance, 8-warp
    CTAs); keys masked past N - 5 for B2 and B12."""
    _serving_attention_cases(card, 2, N, 4, 2, D, N - 5, 128, seed=70 + D)


@pytest.mark.parametrize("N", [641, 864])
def test_serving_attention_kernels_at_head_dim_128_past_640_keys(card, N):
    """At head dim 128 past 640 keys K and the partial outputs outgrow
    shared memory and B2, B11, B12, B15 and B16 take the streaming mode (K
    and V in 128-key chunks): 4/2 heads, up to 864, the largest N JAX's
    flash_supported admits there."""
    _serving_attention_cases(card, 2, N, 4, 2, 128, N - 3, 128, seed=N + 1)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, -123456789)])
@pytest.mark.parametrize("D", [24, 48, 128])
@pytest.mark.parametrize("N", [45, 345])
def test_attention_train_kernels_at_head_dims_24_48_and_128(card, N, D, rate,
                                                            seed):
    """B10 forward and backward at 4/2 heads with head dim 24, 48 (zero-
    padded) and 128 (8-warp forward CTAs, a one-group backward), against
    their plain versions (the tolerances of
    ``test_attention_train_kernels_match_plain``)."""
    hq, hkv = 4, 2
    q, k, v, do = _attn_train_inputs(card, 2, N, hq, hkv, 80 + D, D)
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    grads = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    _assert_grads(grads, at.attention_train_bwd_plain(
        q, k, v, o, do, seed, hq, hkv, rate), q, k, v, do, hq, hkv, rate)


def test_attention_train_is_deterministic_at_head_dim_128(card):
    """Two runs of B10's forward and backward bit-equal at head dim 128."""
    q, k, v, do = _attn_train_inputs(card, 4, 345, 4, 2, 81, 128)
    o, stats = at.attention_train_fwd(q, k, v, 5, 4, 2, 0.1)
    o2, stats2 = at.attention_train_fwd(q, k, v, 5, 4, 2, 0.1)
    assert torch.equal(o, o2) and torch.equal(stats, stats2)
    a = at.attention_train_bwd(q, k, v, o, do, 5, 4, 2, 0.1, stats)
    b = at.attention_train_bwd(q, k, v, o, do, 5, 4, 2, 0.1, stats)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- head dims past 128 ------------------------------------------------------

@pytest.mark.parametrize("B,N,hq,hkv", [(6, 345, 20, 4), (2, 45, 4, 2),
                                         (2, 130, 4, 4)])
@pytest.mark.parametrize("D", [136, 256])
def test_serving_attention_kernels_at_head_dims_136_and_256(card, D, B, N, hq,
                                                            hkv):
    """B2, B11, B12, B15 and B16 with head dim 136 (zero-padded to 256) and
    256: csrc/attention_wide.cu, two output column groups, the scores over
    two depth chunks; at v3's heads (20/4) and N = 345, at tiny's (4/2) and
    N = 45, and without grouping (4/4) at N = 130 (past a 128-key chunk and
    two 64-row tiles); keys masked past N - 5 for B2 and B12, whose out
    projection is 1280 wide; B15 bit-equal to B16."""
    _serving_attention_cases(card, B, N, hq, hkv, D, N - 5, 1280,
                             seed=90 + D + N)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, -123456789)])
@pytest.mark.parametrize("N,hq,hkv", [(345, 20, 4), (45, 4, 2), (130, 4, 4)])
@pytest.mark.parametrize("D", [136, 256])
def test_attention_train_kernels_at_head_dims_136_and_256(card, D, N, hq, hkv,
                                                          rate, seed):
    """B10 forward and backward at head dim 136 (zero-padded) and 256, at
    v3's heads (20/4) and N = 345, tiny's (4/2) and N = 45, and 4/4 at N =
    130, against their plain versions (the tolerances of
    ``test_attention_train_kernels_match_plain``)."""
    q, k, v, do = _attn_train_inputs(card, 2, N, hq, hkv, 90 + D + N, D)
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    grads = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    _assert_grads(grads, at.attention_train_bwd_plain(
        q, k, v, o, do, seed, hq, hkv, rate), q, k, v, do, hq, hkv, rate)


def test_attention_train_is_deterministic_at_head_dim_256(card):
    """Two runs of B10's forward and backward bit-equal at head dim 256."""
    q, k, v, do = _attn_train_inputs(card, 2, 345, 20, 4, 91, 256)
    o, stats = at.attention_train_fwd(q, k, v, 5, 20, 4, 0.1)
    o2, stats2 = at.attention_train_fwd(q, k, v, 5, 20, 4, 0.1)
    assert torch.equal(o, o2) and torch.equal(stats, stats2)
    a = at.attention_train_bwd(q, k, v, o, do, 5, 20, 4, 0.1, stats)
    b = at.attention_train_bwd(q, k, v, o, do, 5, 20, 4, 0.1, stats)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- audio in, audio out ----------------------------------------------------


def test_dac_encoder_on_card_matches_cpu(card):
    """The production codec's encoder and residual VQ (random weights of a
    seed) on 4096 samples: z_e within 3e-4 of its scale, the bound of
    ``tests/test_dac.py`` against the torch mirror; at most 2 % of the codes
    differ (that test's bound: fp32 sums in another order flip near-tied
    argmaxes).  No decode kernel runs in the encoder."""
    from jatsr_torch.models.dac import DAC, DACConfig

    rng = np.random.default_rng(30)
    t = np.arange(4096) / 44100.0
    audio = torch.from_numpy((0.3 * np.sin(2 * np.pi * 440 * t)
                              + 0.05 * rng.standard_normal(4096)).astype(
        np.float32)).reshape(1, -1, 1)
    cpu = DAC.random_init(0, DACConfig(), device="cpu")
    gpu = DAC.random_init(0, DACConfig(), fused_res_units=True,
                          device="cuda")
    counters = (dk.res_unit_fused, dk.res_stage_fused)
    n0 = [c.launches for c in counters]
    z_e = gpu.encode_continuous(audio.cuda()).cpu()
    z_q, codes = gpu.encode(audio.cuda())
    assert [c.launches for c in counters] == n0
    want_e = cpu.encode_continuous(audio)
    want_q, want_codes = cpu.encode(audio)
    assert z_e.shape == (1, 8, 1024) and codes.dtype == torch.int32
    assert (z_e - want_e).abs().max().item() <= \
        3e-4 * want_e.abs().max().item()
    assert (codes.cpu() != want_codes).float().mean().item() <= 0.02


def test_resample_on_card_matches_cpu(card):
    from jatsr_torch.ops.resample import resample

    x = torch.from_numpy(np.random.default_rng(31).uniform(
        -1, 1, (1, 16000)).astype(np.float32))
    got = resample(x.cuda(), 16000, 44100).cpu()
    want = resample(x, 16000, 44100)
    assert got.shape == want.shape == (1, 44100)
    assert (got - want).abs().max().item() <= 2e-6


def _reference_state_dict(cfg, seed):
    """A reference-format DiT ``model_state_dict`` (the key names
    ``models/convert_dit.py`` reads, torch ``[out, in]`` weights) of
    normal weights, std 1/sqrt(fan_in), and biases of std 0.02."""
    rng = np.random.default_rng(seed)
    H, P = cfg.hidden_size, cfg.patch_len
    D = cfg.head_dim
    C2 = cfg.input_channels + cfg.cond_channels
    mlp = int(H * cfg.mlp_ratio)
    shapes = {"patch_embed.proj.0": (cfg.bottleneck_dim, P * C2),
              "patch_embed.proj.2": (H, cfg.bottleneck_dim),
              "t_embedder.1": (H, H), "t_embedder.3": (H, H),
              "final_layer.1": (P * cfg.input_channels, H)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        shapes.update({b + "adaLN_modulation.1": (6 * H, H),
                       b + "mlp.0": (mlp, H), b + "mlp.3": (H, mlp)})
        for name, out_in in (("q_proj", (cfg.num_q_heads * D, H)),
                             ("k_proj", (cfg.num_kv_heads * D, H)),
                             ("v_proj", (cfg.num_kv_heads * D, H)),
                             ("out_proj", (H, cfg.num_q_heads * D))):
            shapes[b + "attn." + name] = out_in
    sd = {}
    for k, (o, i) in shapes.items():
        sd[k + ".weight"] = torch.from_numpy(
            rng.standard_normal((o, i), dtype=np.float32) / np.sqrt(i))
        if ".attn." not in k:
            sd[k + ".bias"] = torch.from_numpy(
                0.02 * rng.standard_normal(o, dtype=np.float32))
    return sd


def test_cli_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """``python -m jatsr_torch.cli.infer`` at ``tiny`` (the bf16 model, the
    random production codec, the fused decode) on the card and with
    ``--platform cpu``: the same wav within relative L2 5e-2, the bound of
    the port's pipeline against JAX's.  A device's generator draws its own
    numbers, so both runs take the CPU's per-chunk noise here."""
    import json

    from jatsr_torch.cli import infer as cli
    from jatsr_torch.configs import get_preset
    from jatsr_torch.infer import pipeline
    from jatsr_torch.utils.audio_io import load_wav, save_wav

    drawn = pipeline._per_chunk_noise
    monkeypatch.setattr(pipeline, "_per_chunk_noise",
                        lambda seed, n, frames, channels, device: drawn(
                            seed, n, frames, channels, "cpu").to(device))

    cfg = get_preset("tiny").model
    torch.save({"model_state_dict": _reference_state_dict(cfg, 32)},
               tmp_path / "model.pt")
    ones, zeros = [1.0] * 1024, [0.0] * 1024
    (tmp_path / "stats.json").write_text(json.dumps(
        {"hr_mean": zeros, "hr_std": ones, "lr_mean": zeros,
         "lr_std": ones}))
    save_wav(tmp_path / "song.wav", (0.3 * np.sin(
        2 * np.pi * 440 * np.arange(8000) / 16000)).astype(np.float32),
        16000)
    wavs = {}
    for platform in ("cuda", "cpu"):
        cli.main(["--torch-checkpoint", str(tmp_path / "model.pt"),
                  "--preset", "tiny", "--stats", str(tmp_path / "stats.json"),
                  "--input", str(tmp_path / "song.wav"), "--output-dir",
                  str(tmp_path / platform), "--steps", "4", "--cfg-scale",
                  "2.0", "--attention", "flash", "--platform", platform])
        wavs[platform], sr = load_wav(tmp_path / platform /
                                      "song_generated_cfg2.0.wav")
    got, want = wavs["cuda"], wavs["cpu"]
    assert sr == 44100 and got.shape == want.shape == (44 * 512,)
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel


# ---- B2's int8 value product and the DAC kernels' bf16 snake ---------------

INT8_QK = [(6, 352, 345, 20, 4, 64), (6, 345, 0, 20, 4, 64),
           (2, 130, 125, 4, 2, 16), (2, 130, 125, 4, 2, 32),
           (6, 345, 340, 20, 4, 48), (6, 345, 340, 20, 4, 128),
           (2, 700, 690, 4, 2, 128), (6, 345, 340, 20, 4, 256),
           (2, 1000, 997, 8, 4, 64), (6, 345, 0, 12, 12, 64)]


@pytest.mark.parametrize("B,N,n_valid,hq,hkv,D", INT8_QK)
def test_flash_qkv_int8_qk_kernel_matches_plain(card, B, N, n_valid, hq, hkv,
                                                D):
    """B2 with int8_qk (the v codes launch, then the attention, each
    counted apart from B2's bf16 launches) at every head dim it runs:
    16/32/64/128 instances, 48 zero-padded to 64, 128 past 640 keys (the
    streaming mode), 256 on the wide kernel; the main path's shape, N =
    1000, and G = 1.  One of the padded rows between n_valid and N holds
    every v column's absmax.  The codes and scales equal their plain
    versions bit for bit, so the outputs part only where a code of e or a
    bf16 rounding flips: within one bf16 ulp of max |plain|, at under 1%
    of the outputs (chip_smoke.py's bound; the bf16 value product is off
    at ~90% of them)."""
    from jatsr_torch.ops.attention import (_deferred_plan, _row_view,
                                           _sm_count, _v_codes, pad_heads,
                                           padded_head_dim, v_codes_plain)

    gen = torch.Generator(device=card).manual_seed(D + N)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * D), generator=gen,
                      device=card).bfloat16()
    if n_valid:
        qkv[:, n_valid + 1, (hq + hkv) * D:] = 6.0
    cos, sin = rope_cos_sin(N, D, device=card)
    n0 = (gqa_attention_flash_qkv.launches,
          gqa_attention_flash_qkv.int8_qk_launches, _v_codes.launches)
    got = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv, n_valid=n_valid,
                                  int8_qk=True).float()
    assert (gqa_attention_flash_qkv.launches,
            gqa_attention_flash_qkv.int8_qk_launches,
            _v_codes.launches) == (n0[0], n0[1] + 1, n0[2] + 1)
    want = flash_qkv_plain(qkv, cos, sin, hq, hkv, n_valid=n_valid,
                           int8_qk=True).float()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= ulp
    assert (got != want).float().mean().item() <= 1e-2
    Dp = padded_head_dim(D)
    v, v_row = _row_view(pad_heads(qkv[..., (hq + hkv) * D:], D, Dp))
    nk = _deferred_plan(N, hq, hkv, Dp, B, _sm_count(card.index or 0),
                        n_valid or N, False).nk
    codes, sv = _v_codes(v, v_row, hkv, Dp, nk)
    want_codes, want_sv = v_codes_plain(v, hkv, nk)
    assert torch.equal(codes, want_codes) and torch.equal(sv, want_sv)


@pytest.fixture
def snake_bf16():
    dk.set_snake_compute_dtype("bfloat16")
    yield
    dk.set_snake_compute_dtype("float32")


def test_dac_kernels_in_bf16_snake_mode_match_plain(card, snake_bf16):
    """B9, B6 (both column tiles, C 384 in two halves), B7 at the three
    stage widths and B8, with the snake in bf16, against their plain
    versions in the same mode: the fp32 mode's bounds."""
    x, w7, b7, w1, b1, a1, a2 = _dac_unit_inputs(card, 2, 1001, 96, 1,
                                                 seed=31)
    _assert_rel(dk.res_unit_fused(x, w7[0], b7[0], w1[0], b1[0], a1[0],
                                  a2[0], dilation=3),
                dk.res_unit_plain(x, w7[0], b7[0], w1[0], b1[0], a1[0],
                                  a2[0], 3), 4e-3)
    for B, T, C in ((2, 777, 96), (2, 1001, 192), (2, 333, 384)):
        args = _dac_unit_inputs(card, B, T, C, 3, seed=32)
        _assert_rel(dk.res_stage_fused(*args), dk.res_stage_plain(*args),
                    4e-3)
    for B, T, ci, co, s in ((2, 101, 192, 96, 2), (2, 100, 384, 192, 4),
                            (1, 2000, 768, 384, 8), (2, 77, 1536, 768, 8)):
        x, w, b, a = _tr_inputs(card, B, T, ci, co, s, seed=33)
        kw = dict(stride=s, padding=(s + 1) // 2, output_padding=s % 2)
        _assert_rel(dk.snake_conv_transpose_fused(x, w, b, a, **kw),
                    dk.snake_conv_transpose_plain(x, w, b, a, **kw))


def test_snake_mode_is_read_at_each_call(card):
    """The same B7 call in fp32 and in bf16 snake mode gives different
    outputs, each its own mode's plain version's; ``b16_launches`` counts
    the bf16-mode launch only."""
    x, w, b, a = _tr_inputs(card, 2, 100, 384, 192, 4, seed=34)
    kw = dict(stride=4, padding=2, output_padding=0)
    fn = dk.snake_conv_transpose_fused
    outs, counts = [], []
    for mode in ("float32", "bfloat16", "float32"):
        dk.set_snake_compute_dtype(mode)
        n0 = (fn.launches, fn.b16_launches)
        try:
            got = fn(x, w, b, a, **kw)
            _assert_rel(got, dk.snake_conv_transpose_plain(x, w, b, a, **kw))
        finally:
            dk.set_snake_compute_dtype("float32")
        outs.append(got)
        counts.append((fn.launches - n0[0], fn.b16_launches - n0[1]))
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])
    assert counts == [(1, 0), (1, 1), (1, 0)]


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_dynamic_int8_dense_dit_on_card_matches_cpu(card, impl):
    """DenseDiT under matmul_precision="int8" (B4 or B14 at every
    projection, the weights quantized at every call) on the card against
    the same weights on the CPU: relative L2 < 2e-2."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.int8_matmul import int8_matmul_fused

    cfg = dataclasses.replace(
        get_preset("tiny").model, hidden_size=256, num_q_heads=4,
        num_kv_heads=2, bottleneck_dim=128, input_channels=64,
        cond_channels=64, matmul_precision="int8", int8_impl=impl,
        attention_impl="flash")
    dense = random_dense_params(cfg, 7)
    rng = np.random.default_rng(8)
    x_t, x_c = (torch.from_numpy(rng.standard_normal((2, 130, 64),
                                                     dtype=np.float32))
                for _ in range(2))
    t = torch.tensor([0.2, 0.9])
    with torch.no_grad():
        ref = DenseDiT(cfg, dense, device="cpu")(x_t, t, x_c)
        model = DenseDiT(cfg, dense, device="cuda")
        n0 = (int8_matmul_fused.launches, int8_matmul.launches)
        out = model(x_t.cuda(), t.cuda(), x_c.cuda()).cpu()
    n = 2 + 6 * cfg.depth
    assert (int8_matmul_fused.launches - n0[0],
            int8_matmul.launches - n0[1]) == (
        (n, 0) if impl == "fused" else (0, n))
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 2e-2


def _tiny_run_preset(tmp, C=32):
    """tiny at 32 channels on 64-frame crops (16 patches) of three
    seeded 120-frame songs; a run under ``tmp``."""
    import dataclasses
    import json

    from jatsr_torch.configs import get_preset

    rs = np.random.RandomState(0)
    for split, count in (("train", 3), ("val", 2)):
        d = tmp / "data" / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            hr = rs.randn(120, C).astype(np.float16)
            np.save(d / f"s{i}.hr.npy", hr)
            np.save(d / f"s{i}.lr.npy",
                    (0.8 * hr + 0.1 * rs.randn(120, C)).astype(np.float16))
    (tmp / "data" / "global_stats_separated.json").write_text(json.dumps(
        {k: [0.0 if k.endswith("mean") else 1.0] * C
         for k in ("hr_mean", "hr_std", "lr_mean", "lr_std")}))
    p = get_preset("tiny")
    return dataclasses.replace(
        p, model=dataclasses.replace(p.model, input_channels=C,
                                     cond_channels=C, dropout=0.1),
        train=dataclasses.replace(
            p.train, batch_size=2, save_dir_base=str(tmp / "ckpt"),
            save_interval_steps=0, num_epochs=2, warmup_steps=5, lr=1e-3),
        data=dataclasses.replace(p.data, target_duration=64 * 512 / 44100,
                                 samples_per_epoch_multiplier=2))


def test_tiny_trainer_on_card_and_its_resume(card, tmp_path):
    """The Trainer on the card (B10 at head dim 32, dropout 0.1; the
    native loader): two epochs straight, then one epoch, a resume from its
    `last` and one more epoch: parameters, moments and count bit-equal
    (the kernels and cuBLAS give the same bits on the same inputs); B10's
    launches 2 x depth forward and depth backward a step (remat
    "full")."""
    from jatsr_torch.train.loop import Trainer

    preset = _tiny_run_preset(tmp_path)
    kw = dict(data_dir=str(tmp_path / "data"), writer=False,
              native_loader=True)
    n0 = (at.attention_train_fwd.launches, at.attention_train_bwd.launches)
    straight = Trainer(preset, run_name="11112222", **kw)
    straight.fit(verbose=False)
    steps = straight.state.step
    depth = preset.model.depth
    assert steps == 6 and straight.model.device.type == "cuda"
    assert (at.attention_train_fwd.launches - n0[0],
            at.attention_train_bwd.launches - n0[1]) == (
        2 * depth * steps, depth * steps)
    first = Trainer(preset, run_name="22223333", **kw)
    first.fit(verbose=False, max_steps=3)
    second = Trainer(preset, resume=str(first.ckpt.run_dir), **kw)
    assert second.start_epoch == 1 and second.state.step == 3
    second.fit(verbose=False)
    a, b = straight.state.state_dict(), second.state.state_dict()
    assert (a["step"], a["opt"]["count"]) == (b["step"], b["opt"]["count"])
    for group in ("mu", "nu"):
        for k, v in a["opt"][group].items():
            assert torch.equal(v, b["opt"][group][k]), (group, k)
    for k, v in a["params"].items():
        assert v.device.type == "cuda" and torch.equal(v, b["params"][k]), k


@pytest.mark.parametrize("policy", ["none", "full", "dots", "attn_out",
                                    "mlp"])
def test_remat_policies_on_card(card, policy):
    """One training forward and backward of the tiny DiT (dropout 0.1,
    drop-path 0.3) under each remat policy on the card: B10's forward
    launches once a block under "none" and twice under the others, its
    backward once; the gradients are bit-equal to those under "none"."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params

    def grads(p):
        cfg = dataclasses.replace(get_preset("tiny").model, dropout=0.1,
                                  drop_path_rate=0.3, remat_policy=p)
        model = DenseDiT(cfg, random_dense_params(cfg, 6), device="cuda")
        rng = np.random.default_rng(7)
        x, c = (torch.from_numpy(rng.standard_normal(
            (2, 130, 1024), dtype=np.float32)).cuda() for _ in range(2))
        n0 = (at.attention_train_fwd.launches,
              at.attention_train_bwd.launches)
        out = model(x, torch.tensor([0.2, 0.6], device="cuda"), c,
                    deterministic=False, layer_seeds=[5, -6])
        (out ** 2).mean().backward()
        n = (at.attention_train_fwd.launches - n0[0],
             at.attention_train_bwd.launches - n0[1])
        return [q.grad for q in model.parameters()], n, cfg.depth

    g, n, depth = grads(policy)
    assert n == ((1 if policy == "none" else 2) * depth, depth)
    g_none, _, _ = grads("none")
    for a, b in zip(g, g_none):
        assert torch.equal(a, b)


# ---- the fp32 modes of B1, B2, B3 and B5, and the dtype branches ------------
# B2's fp32 mode (csrc/attention_f32.cu: fp32 products and sums in another
# order than the plain version's): rtol = atol = 1e-5.  B3's: at most 0.5 %
# of the fp32 outputs past 2^-20 relative (a code moved by the prologue's
# fp32 statistics, as in bf16 mode).  B1's and B5's: the bf16 modes' code
# bounds.  Each launch counts in ``launches`` and ``f32_launches``.

@pytest.mark.parametrize("hq,hkv,D,n,n_valid", [
    (20, 4, 64, 352, 345), (20, 4, 64, 345, 0), (4, 2, 32, 90, 77),
    (2, 1, 128, 70, 0), (2, 2, 256, 65, 60), (3, 1, 48, 100, 0),
    (4, 2, 64, 1000, 990)])
def test_flash_qkv_fp32_kernel_matches_plain(card, hq, hkv, D, n, n_valid):
    gen = torch.Generator(device=card).manual_seed(40 + D)
    qkv = torch.randn((3, n, (hq + 2 * hkv) * D), generator=gen, device=card)
    cos, sin = rope_cos_sin(n, D, device=card)
    n0 = (gqa_attention_flash_qkv.launches,
          gqa_attention_flash_qkv.f32_launches)
    got = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv, n_valid=n_valid)
    assert (gqa_attention_flash_qkv.launches - n0[0],
            gqa_attention_flash_qkv.f32_launches - n0[1]) == (1, 1)
    assert got.dtype == torch.float32
    want = flash_qkv_plain(qkv, cos, sin, hq, hkv, n_valid=n_valid)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    _check_int8_qk_fp32(qkv, cos, sin, hq, hkv, n_valid)


def _fp32_rows(x, seed):
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return x.float() + 1e-3 * torch.randn(x.shape, generator=gen,
                                          device=x.device)


@SHAPES
@ROWS
@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norm_mod_dot_fp32_kernel_matches_plain(card, B, Np, H, N, rows,
                                                norm):
    x, *rest = _prologue_inputs(card, B, Np, H, N, rows, seed=41)
    args = (_fp32_rows(x, 42), *rest)
    n0 = int8_norm_mod_dot.f32_launches
    got = int8_norm_mod_dot(*args, norm=norm, out_dtype=torch.float32,
                            w_t=args[3].t().contiguous())
    assert int8_norm_mod_dot.f32_launches == n0 + 1
    assert got.dtype == torch.float32
    want = norm_mod_dot_plain(*args, norm=norm, out_dtype=torch.float32)
    far = (got - want).abs() > want.abs() * 2.0 ** -20
    assert far.float().mean().item() <= 0.005


@pytest.mark.parametrize("B,Np,H", [(6, 352, 1280), (3, 40, 128),
                                    (2, 37, 1280)])
@ROWS
def test_norm_mod_dense_gelu_quant_fp32_kernel_matches_plain(card, B, Np, H,
                                                             rows):
    x, *rest = _prologue_inputs(card, B, Np, H, 4 * H, rows, seed=43)
    args = (_fp32_rows(x, 44), *rest)
    n0 = int8_norm_mod_dense_gelu_quant.f32_launches
    got_q, got_s = int8_norm_mod_dense_gelu_quant(
        *args, norm="layer", w_t=args[3].t().contiguous())
    assert int8_norm_mod_dense_gelu_quant.f32_launches == n0 + 1
    want_q, want_s = norm_mod_dense_gelu_quant_plain(*args, norm="layer")
    _assert_codes((got_q.reshape(B * Np, -1), got_s.reshape(-1, 1)),
                  (want_q.reshape(B * Np, -1), want_s.reshape(-1, 1)),
                  scale_rtol=2e-3)


@pytest.mark.parametrize("fast_epilogue", [True, False])
@pytest.mark.parametrize("M,K,N", [(2112, 8192, 512), (2070, 1280, 5120),
                                   (100, 4096, 256)])
def test_dense_gelu_quant_fp32_kernel_matches_plain(card, M, K, N,
                                                    fast_epilogue):
    """B5's fp32 mode at the patch embed, at mlp_in without the prologue,
    and at K = 4096 (the fp32 row read twice past 2048); two calls
    bit-equal."""
    a, *rest = _dense_inputs(card, M, K, N, seed=45)
    args = (_fp32_rows(a, 46), *rest)
    w_t = args[1].t().contiguous()
    n0 = int8_dense_gelu_quant.f32_launches
    got = int8_dense_gelu_quant(*args, fast_epilogue=fast_epilogue, w_t=w_t)
    assert int8_dense_gelu_quant.f32_launches == n0 + 1
    _assert_codes(got, dense_gelu_quant_plain(*args,
                                              fast_epilogue=fast_epilogue))
    again = int8_dense_gelu_quant(*args, fast_epilogue=fast_epilogue, w_t=w_t)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("knobs", [
    dict(dtype="float32", fused_prologue=True, align_n=True),
    dict(dtype="float32"),
    dict(dtype="float32", fused_mlp=False, int8_impl="fused"),
    dict(param_dtype="bfloat16", fused_prologue=True, align_n=True)],
    ids=["fp32_prologue", "fp32", "fp32_unfused_mlp", "bf16_tree"])
def test_narrow_dit_dtypes_on_card_match_cpu(card, knobs):
    """The narrow int8 DiT at the fp32 compute dtype (with the fused
    prologue: B3, B2, B4, B1 and B5 in fp32 mode; without it: B2 and B5;
    the unfused QuantDense MLP through B4's fp32 mode) and from a bf16
    tree, on the card against the same weights on the CPU's plain path:
    relative L2 < 2e-2."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    cfg = dataclasses.replace(get_preset("tiny").model, **{
        **dict(hidden_size=256, num_q_heads=4, num_kv_heads=2,
               bottleneck_dim=128, input_channels=64, cond_channels=64,
               matmul_precision="int8_static", fused_qkv=True,
               fused_mlp=True, attention_impl="flash"), **knobs})
    static = quantize_params_static(random_dense_params(cfg, 47), cfg)
    if cfg.param_dtype == "bfloat16":
        static = _bf16_leaves(static)
    rng = np.random.default_rng(48)
    x_t, x_c = (torch.from_numpy(rng.standard_normal((2, 130, 64),
                                                     dtype=np.float32))
                for _ in range(2))
    t = torch.tensor([0.2, 0.9])
    ref = DiT(cfg, static, device="cpu")(x_t, t, x_c)
    n0 = gqa_attention_flash_qkv.f32_launches
    out = DiT(cfg, static, device="cuda")(x_t.cuda(), t.cuda(),
                                          x_c.cuda()).cpu()
    f32 = cfg.dtype == "float32"
    assert gqa_attention_flash_qkv.f32_launches - n0 == (cfg.depth if f32
                                                         else 0)
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 2e-2


def _bf16_leaves(tree):
    """An int8_static numpy tree as a model with bf16 parameters holds it:
    every float leaf but the fp32 scales as a bf16 tensor."""
    return {k: _bf16_leaves(v) if isinstance(v, dict)
            else v if k == "kernel_scale" or v.dtype == np.int8
            else torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
            for k, v in tree.items()}


@pytest.mark.parametrize("knobs", [
    dict(matmul_precision="bf16", param_dtype="bfloat16"),
    dict(matmul_precision="int8", int8_impl="fused", param_dtype="bfloat16"),
    dict(matmul_precision="bf16", dtype="float32", attention_impl="xla"),
    dict(matmul_precision="int8", int8_impl="fused", dtype="float32",
         attention_impl="xla")],
    ids=["bf16_params", "int8_bf16_params", "fp32", "int8_fp32"])
def test_dense_dit_dtypes_on_card_match_cpu(card, knobs):
    """DenseDiT with bf16 parameters (``bench.py --bf16``: B11 a block;
    ``--precision int8``: B4 at every projection) and at the fp32 compute
    dtype with the einsum attention (B4's fp32 mode under int8), on the
    card against the CPU: relative L2 < 2e-2."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params

    cfg = dataclasses.replace(
        get_preset("tiny").model, hidden_size=256, num_q_heads=4,
        num_kv_heads=2, bottleneck_dim=128, input_channels=64,
        cond_channels=64, **{"attention_impl": "flash", **knobs})
    dense = random_dense_params(cfg, 49)
    rng = np.random.default_rng(50)
    x_t, x_c = (torch.from_numpy(rng.standard_normal((2, 130, 64),
                                                     dtype=np.float32))
                for _ in range(2))
    t = torch.tensor([0.2, 0.9])
    with torch.no_grad():
        ref = DenseDiT(cfg, dense, device="cpu")(x_t, t, x_c)
        model = DenseDiT(cfg, dense, device="cuda")
        assert {p.dtype for p in model.parameters()} == {
            getattr(torch, cfg.param_dtype)}
        n0 = (gqa_attention_flash.launches, int8_matmul_fused.f32_launches)
        out = model(x_t.cuda(), t.cuda(), x_c.cuda()).cpu()
    n = (gqa_attention_flash.launches - n0[0],
         int8_matmul_fused.f32_launches - n0[1])
    f32, int8 = cfg.dtype == "float32", cfg.matmul_precision == "int8"
    assert n == (0 if f32 else cfg.depth,
                 2 + 6 * cfg.depth if f32 and int8 else 0)
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 2e-2


# ---- the fp32 modes of B11, B12, B13, B15, B16 and B2's int8_qk -----------
# csrc/attention_f32.cu (B13: mlp_full.cu's fp32 row quant).  B11, B15 and
# B16: rtol = atol = 1e-5 (fp32 products and sums in another order), B15
# and B16 bit-equal to each other (one body, two grids).  B12: max abs
# error <= 1e-2 x max |plain|, its bf16 mode's bound (a head output one
# fp32 ulp apart can still move a code of the row quant by one).  B13: its
# bf16 mode's bounds.  int8_qk: V's codes and scales bit-equal to
# ``v_codes_plain``; the outputs within atol = rtol = 1e-2 (the CPU test's
# bound: a code of e * 127 on a rounding boundary can flip by one), at most
# 1 % of them more than 1e-4 apart.  Each launch counts in ``launches``
# (``int8_qk_launches``) and ``f32_launches`` (``int8_qk_f32_launches``).

def _check_int8_qk_fp32(qkv, cos, sin, hq, hkv, n_valid):
    import torch.nn.functional as F

    from jatsr_torch.ops.attention import (_v_codes, padded_head_dim,
                                           v_codes_plain)

    f = gqa_attention_flash_qkv
    n0 = (f.launches, f.int8_qk_launches, f.int8_qk_f32_launches,
          _v_codes.launches)
    got = f(qkv, cos, sin, hq, hkv, n_valid=n_valid, int8_qk=True)
    assert (f.launches, f.int8_qk_launches, f.int8_qk_f32_launches,
            _v_codes.launches) == (n0[0], n0[1] + 1, n0[2] + 1, n0[3] + 1)
    assert got.dtype == torch.float32
    want = flash_qkv_plain(qkv, cos, sin, hq, hkv, n_valid=n_valid,
                           int8_qk=True)
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    assert ((got - want).abs() > 1e-4).float().mean().item() <= 1e-2
    B, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    dc = padded_head_dim(D)
    v = F.pad(qkv[..., (hq + hkv) * D:].reshape(B, N, hkv, D),
              (0, dc - D)).reshape(B, N, hkv * dc)
    nk = -(-N // 128) * 128
    codes, sv = _v_codes(v, v.stride(1), hkv, dc, nk)
    want_codes, want_sv = v_codes_plain(v, hkv, nk)
    assert torch.equal(codes, want_codes) and torch.equal(sv, want_sv)


def _split_fp32(card, B, N, hq, hkv, D, seed, negative=None):
    """fp32 q [B, N, hq, D], k/v [B, N, hkv, D]; ``negative``: every q
    negative and every k positive, so that each real score of every row is
    below 0 and B11's zero keys hold the row max.  "scaled": q times 4 /
    sqrt(D), the scores near -4 at every D; "unscaled": as drawn, the
    scores near -(2 / pi) sqrt(D) (-10 at D 256), where the real keys'
    share of B11's l is small and taking the zero keys' share off l
    cancels most of it, in the JAX kernel as here (see
    :func:`_zero_key_rtol`)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn((B, N, h, D), generator=gen, device=card)
               for h in (hq, hkv, hkv))
    if negative:
        q, k = -q.abs(), k.abs()
    if negative == "scaled":
        q = q * (4.0 / math.sqrt(D))
    return q, k, v


def _zero_key_rtol(q, k):
    """B11's rtol where its zero keys hold the row max: l = l_real + npad
    exp2(-m), and l_real = l - npad exp2(-m) carries l's rounding error
    magnified by l / l_real.  Each side's fp32 sum of l's terms rounds at
    l's scale about log2(limit) times (a lane's running sum, then the
    tree), a unit roundoff u = 2^-24 each: rtol = 1e-5 + 2 log2(limit) u
    max(l / l_real) over the rows (float64 here), for the two sides."""
    B, N, hq, D = q.shape
    limit = -(-N // 8) * 8
    kk = k.double().repeat_interleave(hq // k.shape[2], 2)
    s = torch.einsum("bnhd,bmhd->bhnm", q.double(), kk) * (
        math.log2(math.e) / math.sqrt(D))
    m = s.amax(-1).clamp_min(0)  # the zero keys score 0
    l_real = torch.exp2(s - m[..., None]).sum(-1)
    ratio = ((l_real + (limit - N) * torch.exp2(-m)) / l_real).max().item()
    return 1e-5 + 2 * math.log2(limit) * 2.0 ** -24 * ratio


@pytest.mark.parametrize("B,N,hq,hkv,D,negative", [
    (6, 345, 20, 4, 64, None), (2, 45, 4, 2, 16, "scaled"),
    (2, 130, 4, 2, 64, None), (2, 90, 2, 2, 128, None),
    (2, 70, 4, 2, 256, "scaled"), (2, 70, 4, 2, 256, "unscaled"),
    (3, 100, 6, 2, 48, None), (2, 1000, 8, 4, 64, None),
    (1, 1378, 4, 2, 32, None)])
def test_split_attention_fp32_kernels_match_plain(card, B, N, hq, hkv, D,
                                                  negative):
    """B11 (flat views; N padded to 8 with zero keys in the row max), B15
    and B16 (head views) in fp32 mode at the serving shape, tiny's and
    other head dims (16 to 256, 48 not a tile's), N past 1024 (B15/B16's
    streaming range in bf16), and rows whose real scores are all negative
    (B11 at :func:`_zero_key_rtol` where they are far below 0)."""
    q, k, v = _split_fp32(card, B, N, hq, hkv, D, seed=200 + N + D,
                          negative=negative)
    flat = [t.reshape(B, N, -1) for t in (q, k, v)]
    n0 = (gqa_attention_flash.launches, gqa_attention_flash.f32_launches)
    got = gqa_attention_flash(*flat, hq, hkv)
    assert (gqa_attention_flash.launches - n0[0],
            gqa_attention_flash.f32_launches - n0[1]) == (1, 1)
    assert got.dtype == torch.float32 and got.shape == (B, N, hq * D)
    rtol = _zero_key_rtol(q, k) if negative == "unscaled" else 1e-5
    torch.testing.assert_close(got, flash_split_plain(*flat, hq, hkv),
                               atol=1e-5, rtol=rtol)
    outs = []
    for fn in (gqa_attention, gqa_attention_grouped):
        n0 = (fn.launches, fn.f32_launches)
        outs.append(fn(q, k, v))
        assert (fn.launches - n0[0], fn.f32_launches - n0[1]) == (1, 1)
    assert outs[0].dtype == torch.float32
    torch.testing.assert_close(outs[0], gqa_attention_plain(q, k, v),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(outs[0], outs[1])


def test_split_attention_fp32_refuses_mixed_dtypes(card):
    q, k, v = _split_fp32(card, 1, 40, 4, 2, 32, seed=210)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        gqa_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        gqa_attention_flash(q.reshape(1, 40, -1).half(),
                            k.reshape(1, 40, -1).half(),
                            v.reshape(1, 40, -1).half(), 4, 2)


@pytest.mark.parametrize("B,N,n_valid,hq,hkv,D,H", [
    (6, 352, 345, 20, 4, 64, 1280), (2, 90, 0, 8, 2, 32, 256),
    (6, 352, 345, 20, 4, 48, 1280), (2, 65, 60, 4, 2, 256, 384)])
def test_flash_out_fp32_kernel_matches_plain(card, B, N, n_valid, hq, hkv, D,
                                             H):
    """B12's fp32 mode (the attention into an fp32 scratch at the weight's
    padded head dim, the fp32 row quant, the s8 GEMM writing fp32) at the
    serving shape, a small one, head dim 48 (the DiT's padded K-major
    weight) and 256.  Then the codes themselves, read back through an
    identity out projection (``out = o_q * so``, zero columns past hq D up
    to a multiple of 128), against the plain version's: the row quant hides
    o's precision from the outputs, where a head output in less than fp32
    still passes, but it flips many more codes than 0.5 %."""
    gen = torch.Generator(device=card).manual_seed(220 + D)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * D), generator=gen, device=card)
    cos, sin = rope_cos_sin(N, D, device=card)
    _, wo_q, wo_s, bo = _dense_inputs(card, 1, hq * D, H, seed=221 + D)
    f = gqa_attention_flash_out
    n0 = (f.launches, f.f32_launches)
    got = f(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv, n_valid=n_valid,
            wo_t=flash_out_weight_t(wo_q, hq, D))
    assert (f.launches - n0[0], f.f32_launches - n0[1]) == (1, 1)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = flash_out_plain(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                           n_valid=n_valid)
    _assert_rel(got, want, 1e-2)
    K = hq * D
    eye = torch.eye(K, -(-K // 128) * 128, dtype=torch.int8, device=card)
    ones = torch.ones((1, eye.shape[1]), device=card)
    zeros = torch.zeros_like(ones)
    got = f(qkv, cos, sin, eye, ones, zeros, hq, hkv, n_valid=n_valid,
            wo_t=flash_out_weight_t(eye, hq, D))
    want = flash_out_plain(qkv, cos, sin, eye, ones, zeros, hq, hkv,
                           n_valid=n_valid)
    assert not got[..., K:].any()
    _assert_codes(_identity_codes(got[..., :K]),
                  _identity_codes(want[..., :K]))


def _identity_codes(out):
    """The codes and row scales of an identity out projection's output
    ``o_q * so`` (each row's largest code is 127)."""
    so = out.abs().amax(dim=-1, keepdim=True) / 127
    return torch.round(out / so).to(torch.int8), so


@pytest.mark.parametrize("M,H,N1,gelu_impl", [
    (2112, 1280, 5120, "tanh"), (100, 256, 1024, "sigmoid"),
    (70, 256, 384, "erf")])
def test_int8_mlp_fp32_kernel_matches_plain(card, M, H, N1, gelu_impl):
    """B13's fp32 mode: fp32 rows through the reciprocal row quant, the
    rest as in bf16 mode, bf16 out; its bf16 mode's bounds, and two calls
    bit-equal."""
    a, *w = _mlp_args(card, M, H, N1, seed=230)
    args = (a.float() + 1e-3 * torch.randn(a.shape, device=card), *w)
    kt = _mlp_t(args)
    n0 = (int8_mlp.launches, int8_mlp.f32_launches)
    got = int8_mlp(*args, gelu_impl=gelu_impl, **kt)
    assert (int8_mlp.launches - n0[0], int8_mlp.f32_launches - n0[1]) == (1, 1)
    assert got.dtype == torch.bfloat16
    want = mlp_plain(*args, gelu_impl=gelu_impl).float()
    assert (got.float() != want).float().mean().item() <= 1e-3
    torch.testing.assert_close(got.float(), want, atol=0.02, rtol=0.02)
    assert torch.equal(got, int8_mlp(*args, gelu_impl=gelu_impl, **kt))


FP32_BRANCHES = {  # knobs -> (the wrapper whose fp32 mode runs, its counter)
    "B11": (dict(fused_qkv=False), gqa_attention_flash, "f32_launches"),
    "B11_no_flash_qkv": (dict(flash_qkv=False), gqa_attention_flash,
                         "f32_launches"),
    "B12": (dict(flash_fused_out=True), gqa_attention_flash_out,
            "f32_launches"),
    "B13": (dict(fused_mlp_impl="full"), int8_mlp, "f32_launches"),
    "B15": (dict(attention_impl="pallas"), gqa_attention, "f32_launches"),
    "B16": (dict(attention_impl="pallas2"), gqa_attention_grouped,
            "f32_launches"),
    "int8_qk": (dict(flash_int8_qk=True), gqa_attention_flash_qkv,
                "int8_qk_f32_launches"),
}


@pytest.mark.parametrize("name", list(FP32_BRANCHES))
def test_narrow_dit_fp32_branches_on_card_match_cpu(card, name):
    """The narrow int8 DiT at dtype="float32" on each branch whose kernel
    gained its fp32 mode here, on the card against the CPU's plain path:
    the mode launched once a block, relative L2 < 2e-2."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    knobs, fn, attr = FP32_BRANCHES[name]
    cfg = dataclasses.replace(get_preset("tiny").model, **{
        **dict(hidden_size=256, num_q_heads=4, num_kv_heads=2,
               bottleneck_dim=128, input_channels=64, cond_channels=64,
               matmul_precision="int8_static", fused_qkv=True,
               fused_mlp=True, attention_impl="flash", dtype="float32"),
        **knobs})
    static = quantize_params_static(random_dense_params(cfg, 240), cfg)
    rng = np.random.default_rng(241)
    x_t, x_c = (torch.from_numpy(rng.standard_normal((2, 130, 64),
                                                     dtype=np.float32))
                for _ in range(2))
    t = torch.tensor([0.2, 0.9])
    ref = DiT(cfg, static, device="cpu")(x_t, t, x_c)
    n0 = getattr(fn, attr)
    out = DiT(cfg, static, device="cuda")(x_t.cuda(), t.cuda(),
                                          x_c.cuda()).cpu()
    assert getattr(fn, attr) - n0 == cfg.depth
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 2e-2


@pytest.mark.parametrize("impl,fn", [("flash", gqa_attention_flash),
                                     ("pallas", gqa_attention),
                                     ("pallas2", gqa_attention_grouped)])
def test_dense_dit_fp32_attention_on_card_matches_cpu(card, impl, fn):
    """DenseDiT at dtype="float32" with B11, B15 or B16 (fp32 mode, once a
    block), on the card against the CPU: relative L2 < 2e-2."""
    import dataclasses

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params

    cfg = dataclasses.replace(
        get_preset("tiny").model, hidden_size=256, num_q_heads=4,
        num_kv_heads=2, bottleneck_dim=128, input_channels=64,
        cond_channels=64, dtype="float32", attention_impl=impl)
    dense = random_dense_params(cfg, 242)
    rng = np.random.default_rng(243)
    x_t, x_c = (torch.from_numpy(rng.standard_normal((2, 130, 64),
                                                     dtype=np.float32))
                for _ in range(2))
    t = torch.tensor([0.2, 0.9])
    with torch.no_grad():
        ref = DenseDiT(cfg, dense, device="cpu")(x_t, t, x_c)
        n0 = fn.f32_launches
        out = DenseDiT(cfg, dense, device="cuda")(x_t.cuda(), t.cuda(),
                                                  x_c.cuda()).cpu()
    assert fn.f32_launches - n0 == cfg.depth
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() < 2e-2


# ---- B10's fp32 mode (csrc/attention_f32.cu's train mode, the backward in
# csrc/attention_f32_bwd.cu), and training at fp32 and with bf16 parameters.
# Both versions compute every product in fp32 (TF32 off), the kernels' sums
# in another order: each output and gradient within 1e-4 x max |plain| (a
# sum of n fp32 terms in another order moves it by at most ~n u of the sum
# of their magnitudes, u = 2^-24: at n = 768 about 5e-5 of it; measured
# errors are far below); where dq and dk vanish in exact arithmetic (N = 1:
# p = 1 and o = c v, c = coef where the weight is kept, so ds = scale (c
# do.v - do.o), two fp32 sums of the same D products and two roundings of
# c; ds = 0 where it is dropped) both stay below scale x (2 D + 4) u x c x
# max sum |do v| times max |k| (dq) or G max |q| (dk).
REL_F32_TRAIN = 1e-4


def _f32_train_inputs(card, B, N, hq, hkv, D, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn((B, N, w * D), generator=gen, device=card)
            for w in (hq, hkv, hkv, hq)]


def _assert_f32_grads(got, ref, q, k, v, do, hq, hkv, rate):
    B, N, QD = q.shape
    G, D = hq // hkv, QD // hq
    d = do.reshape(B, N, hkv, G, D)
    prods = (d * v.reshape(B, N, hkv, 1, D)).abs().sum(-1).max().item()
    ds_noise = D ** -0.5 * (2 * D + 4) * 2.0 ** -24 * prods / (1.0 - rate)
    vanish = N == 1
    for name, g, r, other in zip(("dq", "dk", "dv"), got, ref,
                                 (k, G * q, None)):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert torch.isfinite(g).all(), name
        if vanish and other is not None:
            bound = ds_noise * other.abs().max().item()
            for x in (g, r):
                assert x.abs().max().item() <= bound, (name, bound)
            continue
        err = (g - r).abs().max().item()
        assert err <= REL_F32_TRAIN * r.abs().max().item(), (name, err)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, -123456789)])
@pytest.mark.parametrize("N,hq,hkv,D", [
    (1, 4, 2, 32), (45, 4, 2, 32), (129, 8, 4, 64), (345, 20, 4, 64),
    (70, 3, 1, 48), (200, 4, 2, 128), (100, 4, 2, 256), (768, 4, 2, 64),
    (768, 4, 2, 256)])
def test_attention_train_fp32_kernels_match_plain(card, N, hq, hkv, D, rate,
                                                  seed):
    """B10's fp32 forward and backward against their plain versions: batch
    28 at the v3mod2 shape, batch 2 elsewhere (G 1, 2, 3, 5; D 32 to 256;
    N 1 to 768, a multiple of 8 and not); each launch counted in both
    ``launches`` and ``f32_launches``."""
    B = 28 if (N, hq, D) == (345, 20, 64) else 2
    q, k, v, do = _f32_train_inputs(card, B, N, hq, hkv, D, 31)
    fwd, bwd = at.attention_train_fwd, at.attention_train_bwd
    n0 = (fwd.launches, fwd.f32_launches, bwd.launches, bwd.f32_launches)
    o, stats = fwd(q, k, v, seed, hq, hkv, rate)
    grads = bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    assert (fwd.launches, fwd.f32_launches, bwd.launches,
            bwd.f32_launches) == tuple(n + 1 for n in n0)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    assert o.dtype == torch.float32 and torch.isfinite(o).all()
    err = (o - want).abs().max().item()
    assert err <= REL_F32_TRAIN * want.abs().max().item(), err
    _assert_f32_grads(grads, at.attention_train_bwd_plain(
        q, k, v, o, do, seed, hq, hkv, rate), q, k, v, do, hq, hkv, rate)


@pytest.mark.parametrize("D", [64, 256])
def test_attention_train_fp32_backward_is_deterministic(card, D):
    """Two runs of the fp32 forward (output and statistics) and of the fp32
    backward are bit-equal (no atomics)."""
    q, k, v, do = _f32_train_inputs(card, 28 if D == 64 else 4, 345, 20, 4,
                                    D, 32)
    o, stats = at.attention_train_fwd(q, k, v, 5, 20, 4, 0.1)
    o2, stats2 = at.attention_train_fwd(q, k, v, 5, 20, 4, 0.1)
    assert torch.equal(o, o2) and torch.equal(stats, stats2)
    a = at.attention_train_bwd(q, k, v, o, do, 5, 20, 4, 0.1, stats)
    b = at.attention_train_bwd(q, k, v, o, do, 5, 20, 4, 0.1, stats)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 256])
def test_attention_train_kernels_with_a_batch_offset(card, dtype, D):
    """B10 at a batch offset ``b0 = 3`` (the rows a data-parallel rank holds
    from the fourth on): forward and backward against their plain versions
    at that offset (the bounds above), and bit-equal to the same rows of a
    launch over the whole batch (a CTA reads only its own (batch, head), so
    the offset is the only change); at ``b0 = 0`` a launch differs from it
    (the hash takes the offset)."""
    B, N, hq, hkv, rate, seed, b0 = 6, 345, 20, 4, 0.1, -123456789, 3
    q, k, v, do = (_attn_train_inputs(card, B, N, hq, hkv, 51, D)
                   if dtype == "bfloat16"
                   else _f32_train_inputs(card, B, N, hq, hkv, D, 51))
    sl = slice(b0, B)
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    full = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    qs, ks, vs, dos = (t[sl].contiguous() for t in (q, k, v, do))
    o3, stats3 = at.attention_train_fwd(qs, ks, vs, seed, hq, hkv, rate,
                                        b0=b0)
    part = at.attention_train_bwd(qs, ks, vs, o3, dos, seed, hq, hkv, rate,
                                  stats3, b0=b0)
    assert torch.equal(o3, o[sl]) and torch.equal(stats3, stats[sl])
    for a, f in zip(part, full):
        assert torch.equal(a, f[sl])
    want = at.attention_train_fwd_plain(qs, ks, vs, seed, hq, hkv, rate,
                                        b0=b0)
    ref = at.attention_train_bwd_plain(qs, ks, vs, o3, dos, seed, hq, hkv,
                                       rate, b0=b0)
    if dtype == "bfloat16":
        torch.testing.assert_close(o3.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        _assert_grads(part, ref, qs, ks, vs, dos, hq, hkv, rate)
    else:
        err = (o3 - want).abs().max().item()
        assert err <= REL_F32_TRAIN * want.abs().max().item(), err
        _assert_f32_grads(part, ref, qs, ks, vs, dos, hq, hkv, rate)
    o0, _ = at.attention_train_fwd(qs, ks, vs, seed, hq, hkv, rate)
    assert not torch.equal(o0, o3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 256])
def test_attention_train_kernels_with_a_head_offset(card, dtype, D):
    """B10 at a head offset ``h0 = 10`` (the second of two tensor-parallel
    ranks: q heads 10-19, kv heads 2-3): forward and backward against
    their plain versions at that offset (the bounds above), and bit-equal
    to the same heads of a launch over all heads (the kv grouping local,
    the hash keyed by the global head); at ``h0 = 0`` a launch differs."""
    B, N, hq, hkv, rate, seed, M = 4, 345, 20, 4, 0.1, -123456789, 2
    q, k, v, do = (_attn_train_inputs(card, B, N, hq, hkv, 52, D)
                   if dtype == "bfloat16"
                   else _f32_train_inputs(card, B, N, hq, hkv, D, 52))
    h, g, h0 = hq // M, hkv // M, hq // M
    qs_, ks_ = slice(h0 * D, hq * D), slice(g * D, hkv * D)
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    full = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    qs, dos = (t[..., qs_].contiguous() for t in (q, do))
    ks, vs = (t[..., ks_].contiguous() for t in (k, v))
    o1, st1 = at.attention_train_fwd(qs, ks, vs, seed, h, g, rate, h0=h0)
    part = at.attention_train_bwd(qs, ks, vs, o1, dos, seed, h, g, rate,
                                  st1, h0=h0)
    assert torch.equal(o1, o[..., qs_]) and torch.equal(st1, stats[:, h0:])
    for a, f, s in zip(part, full, (qs_, ks_, ks_)):
        assert torch.equal(a, f[..., s])
    want = at.attention_train_fwd_plain(qs, ks, vs, seed, h, g, rate,
                                        h0=h0)
    ref = at.attention_train_bwd_plain(qs, ks, vs, o1, dos, seed, h, g,
                                       rate, h0=h0)
    if dtype == "bfloat16":
        torch.testing.assert_close(o1.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        _assert_grads(part, ref, qs, ks, vs, dos, h, g, rate)
    else:
        err = (o1 - want).abs().max().item()
        assert err <= REL_F32_TRAIN * want.abs().max().item(), err
        _assert_f32_grads(part, ref, qs, ks, vs, dos, h, g, rate)
    o0, _ = at.attention_train_fwd(qs, ks, vs, seed, h, g, rate)
    assert not torch.equal(o0, o1)


# ---- the split entries of tensor parallelism (ops/split.py) ---------------


class _Rank:
    """A rank of a two-rank model group on one card, as a thread: each
    collective waits for both ranks' tensors and combines them (the same
    stream orders every copy)."""

    def __init__(self, barrier, store, r):
        self.barrier, self.store, self.r = barrier, store, r

    def _reduce(self, t, op):
        self.store[self.r] = t.clone()
        self.barrier.wait()
        both = op(self.store[0], self.store[1])
        self.barrier.wait()
        return t.copy_(both)

    def max_(self, t):
        return self._reduce(t, torch.maximum)

    def sum_(self, t):
        return self._reduce(t, torch.add)


def _two_ranks(fn):
    """``fn(rank, group)`` on two threads, one a rank; the two results."""
    import threading

    barrier, store, out = threading.Barrier(2), {}, [None, None]

    def run(r):
        out[r] = fn(r, _Rank(barrier, store, r))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    return out


def _half(t, r, dim=-1):
    n = t.shape[dim] // 2
    return t.narrow(dim, r * n, n).contiguous()


@pytest.mark.parametrize("B,Np,H", [(6, 352, 1280), (3, 40, 128)])
def test_b1_split_over_two_ranks_equals_the_whole_kernel(card, B, Np, H):
    """B1's split entry on each rank's half of mlp_in's columns (its pass 1,
    the row maxima's max, pass 2 on it): the two halves' codes joined, and
    each rank's row scales, bit-equal to B1 on the whole width; against
    the plain version as B1 is."""
    from jatsr_torch.ops.split import int8_norm_mod_dense_gelu_quant_split

    x, sc, sh, w_q, w_s, b = _prologue_inputs(card, B, Np, H, 4 * H,
                                              "per_sample", seed=8)
    want = int8_norm_mod_dense_gelu_quant(x, sc, sh, w_q, w_s, b, norm="rms",
                                          w_t=w_q.t().contiguous())
    n0 = int8_norm_mod_dense_gelu_quant_split.launches
    outs = _two_ranks(lambda r, g: int8_norm_mod_dense_gelu_quant_split(
        x, sc, sh, _half(w_q, r), _half(w_s, r), _half(b, r), g, norm="rms",
        w_t=_half(w_q, r).t().contiguous()))
    assert int8_norm_mod_dense_gelu_quant_split.launches == n0 + 2
    assert torch.equal(torch.cat([o[0] for o in outs], -1), want[0])
    assert all(torch.equal(o[1], want[1]) for o in outs)
    plain = norm_mod_dense_gelu_quant_plain(x, sc, sh, w_q, w_s, b, norm="rms")
    _assert_codes((want[0].reshape(B * Np, -1), want[1].reshape(-1, 1)),
                  (plain[0].reshape(B * Np, -1), plain[1].reshape(-1, 1)),
                  scale_rtol=2e-3)


@pytest.mark.parametrize("M,K,N", [(2070, 1280, 5120), (100, 256, 512)])
@pytest.mark.parametrize("fast", [True, False])
def test_b5_split_over_two_ranks_equals_the_whole_kernel(card, M, K, N,
                                                         fast):
    from jatsr_torch.ops.split import int8_dense_gelu_quant_split

    a, w_q, w_s, b = _dense_inputs(card, M, K, N, seed=3)
    want = int8_dense_gelu_quant(a, w_q, w_s, b, fast_epilogue=fast,
                                 w_t=w_q.t().contiguous())
    outs = _two_ranks(lambda r, g: int8_dense_gelu_quant_split(
        a, _half(w_q, r), _half(w_s, r), _half(b, r), g, fast_epilogue=fast,
        w_t=_half(w_q, r).t().contiguous()))
    assert torch.equal(torch.cat([o[0] for o in outs], -1), want[0])
    assert all(torch.equal(o[1], want[1]) for o in outs)


@pytest.mark.parametrize("M,K,N", [(2112, 1280, 1280), (100, 256, 384)])
def test_b4_split_over_two_ranks_equals_the_whole_kernel(card, M, K, N):
    """B4's split entry on each rank's half of the input's columns and of
    the kernel's rows, with an all-zero row and one large value: the row
    maxima, the codes and the int32 products bit-equal to their plain
    versions, the output on both ranks bit-equal to B4."""
    from jatsr_torch.ops.split import int8_matmul_fused_split

    a, w_q, w_s, _ = _dense_inputs(card, M, K, N, seed=9)
    a[3] = 0.0
    a[5, 7] = 3.0e4
    want = int8_matmul_fused(a, w_q, w_s, w_t=w_q.t().contiguous())
    parts = [{}, {}]
    outs = _two_ranks(lambda r, g: int8_matmul_fused_split(
        _half(a, r), _half(w_q, r, 0), w_s, g,
        w_t=_half(w_q, r, 0).t().contiguous(), parts=parts[r]))
    amax = a.float().abs().amax(dim=-1)
    s = (amax[:, None] * _INV127).clamp_min(1e-12)
    for r, (o, p) in enumerate(zip(outs, parts)):
        assert torch.equal(o, want)
        assert torch.equal(p["amax"], amax)
        a_q = torch.round(_half(a, r).float() / s).to(torch.int8)
        assert torch.equal(p["a_q"], a_q) and torch.equal(p["s"], s)
        assert torch.equal(p["acc_local"], int8_mm(a_q, _half(w_q, r, 0)))


@pytest.mark.parametrize("M,K,N", [(2112, 1280, 1280), (2112, 5120, 1280),
                                   (100, 256, 384)])
def test_b14_split_over_two_ranks_equals_the_whole_kernel(card, M, K, N):
    """B14's row-parallel entry (``w8a8_dot(impl="pallas")`` on each rank's
    half of the input's columns and of the kernel's rows), with an all-zero
    row, one large value and a row whose max|a| / 127 is below the 1e-12
    floor (there the floored and unfloored scales differ): the row maxima,
    the codes, the unfloored scale and the int32 products as their plain
    versions have them, the output on both ranks bit-equal to
    ``w8a8_dot(impl="pallas")`` on the whole width (the row quant, B14)."""
    from jatsr_torch.ops.quant import w8a8_dot
    from jatsr_torch.ops.split import int8_matmul_split

    a, w_q, w_s, _ = _dense_inputs(card, M, K, N, seed=19)
    a[3] = 0.0
    a[5, 7] = 3.0e4
    a[7] *= 1e-12
    want = w8a8_dot(a, w_q, w_s, impl="pallas", w_t=w_q.t().contiguous())
    n0 = int8_matmul_split.launches
    parts = [{}, {}]
    outs = _two_ranks(lambda r, g: int8_matmul_split(
        _half(a, r), _half(w_q, r, 0), w_s, g,
        w_t=_half(w_q, r, 0).t().contiguous(), parts=parts[r]))
    assert int8_matmul_split.launches == n0 + 2
    amax = a.float().abs().amax(dim=-1)
    s = amax[:, None] * _INV127
    for r, (o, p) in enumerate(zip(outs, parts)):
        assert torch.equal(o.view(torch.int16), want.view(torch.int16))
        assert torch.equal(p["amax"], amax) and torch.equal(p["s"], s)
        a_q = torch.round(_half(a, r).float() / s.clamp_min(1e-12)).to(
            torch.int8)
        assert torch.equal(p["a_q"], a_q)
        assert torch.equal(p["acc_local"], int8_mm(a_q, _half(w_q, r, 0)))


def _rank_qkv(qkv, hq, hkv, r):
    """Rank r of two's columns of a fused qkv: its q heads, its kv heads'
    k, then their v (``parallel.mesh.qkv_columns``)."""
    D = qkv.shape[-1] // (hq + 2 * hkv)
    q, kv = hq // 2, hkv // 2
    spans = [(r * q, (r + 1) * q), (hq + r * kv, hq + (r + 1) * kv),
             (hq + hkv + r * kv, hq + hkv + (r + 1) * kv)]
    return torch.cat([qkv[..., a * D:b * D] for a, b in spans], -1)


@pytest.mark.parametrize("hq,hkv,D,N", [(20, 4, 64, 352), (4, 2, 32, 90),
                                        (4, 2, 48, 90)])
def test_b12_split_over_two_ranks_equals_the_whole_kernel(card, hq, hkv, D,
                                                          N):
    """B12's split entry on each rank's heads and rows of wo (at head dim
    48 padded to 64: the rank's K-major wo keeps each head's zero rows),
    keys masked past N - 7: the output on both ranks bit-equal to B12 on
    every head."""
    from jatsr_torch.ops.split import gqa_attention_flash_out_split

    gen = torch.Generator(device=card).manual_seed(23)
    qkv = torch.randn((3, N, (hq + 2 * hkv) * D), generator=gen,
                      device=card).bfloat16()
    cos, sin = rope_cos_sin(N, D, device=card)
    _, wo_q, wo_s, bo = _dense_inputs(card, 1, hq * D, 256, seed=24)
    want = gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                                   n_valid=N - 7,
                                   wo_t=flash_out_weight_t(wo_q, hq, D))
    n0 = gqa_attention_flash_out_split.launches
    outs = _two_ranks(lambda r, g: gqa_attention_flash_out_split(
        _rank_qkv(qkv, hq, hkv, r).contiguous(), cos, sin, _half(wo_q, r, 0),
        wo_s, bo, hq // 2, hkv // 2, g, n_valid=N - 7,
        wo_t=flash_out_weight_t(_half(wo_q, r, 0), hq // 2, D)))
    assert gqa_attention_flash_out_split.launches == n0 + 2
    for o in outs:
        assert torch.equal(o.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("M,K,N1,N2", [(2112, 1280, 5120, 1280),
                                       (2112, 1280, 1280, 1280),
                                       (100, 256, 512, 256)])
def test_b13_split_over_two_ranks_equals_the_whole_kernel(card, M, K, N1,
                                                          N2):
    """B13's split entry on each rank's half of w1's columns and w2's rows:
    at N1 5120 each rank holds two whole slabs of 1280, at 1280 and 512
    the ranks share the one slab.  The output on both ranks bit-equal to
    B13 on the whole width, and to the plain version's split as B13 is to
    its plain version."""
    from jatsr_torch.ops.split import int8_mlp_split

    a, w1q, w1s, b1 = _dense_inputs(card, M, K, N1, seed=25)
    _, w2q, w2s, b2 = _dense_inputs(card, 1, N1, N2, seed=26)
    want = int8_mlp(a, w1q, w1s, b1, w2q, w2s, b2, w1_t=w1q.t().contiguous(),
                    w2_t=w2q.t().contiguous())
    n0 = int8_mlp_split.launches
    outs = _two_ranks(lambda r, g: int8_mlp_split(
        a, _half(w1q, r), _half(w1s, r), _half(b1, r), _half(w2q, r, 0), w2s,
        b2, g, rank=r, ranks=2, w1_t=_half(w1q, r).t().contiguous(),
        w2_t=_half(w2q, r, 0).t().contiguous()))
    assert int8_mlp_split.launches == n0 + 2
    for o in outs:
        assert torch.equal(o.view(torch.int16), want.view(torch.int16))
    plain = mlp_plain(a, w1q, w1s, b1, w2q, w2s, b2).float()
    frac = (want.float() != plain).float().mean().item()
    assert frac <= 1e-3
