"""The K-major weight copies and the launch plan of B5 and B13 on the CPU.

B5 (``int8_dense_gelu_quant``) and B13 (``int8_mlp``) run on the s8
``wgmma`` core on the card, which reads 8-bit operands K-major only: the
serving DiT keeps the patch embed's and mlp_in's kernels a second time
transposed, and mlp_out's where the whole MLP runs
(``fused_mlp_impl="full"``), and hands those very tensors to the kernels.
B13's launch plan (``ops/int8_matmul.py:mlp_plan``, pure Python, the
numbers ``csrc/mlp_full.cu`` computes) covers every (row, slab, column
tile) of the hidden activation once.  Both wrappers check the copies'
shapes on the CPU too, where the plain versions read ``w_q`` and equal
themselves with or without a copy.
"""


import numpy as np
import pytest
import torch

from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DiT
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.ops.int8_matmul import (_SMEM_LIMIT, int8_dense_gelu_quant,
                                         int8_mlp, mlp_plan)
from jatsr_torch.ops.quant import quantize_params_static

from torch_parity import C, Spy, narrow_cfg

PROLOGUE = dict(fused_prologue=True, align_n=True)


def _model(seed, **knobs):
    cfg = narrow_cfg(get_preset, "rms", **knobs)
    return DiT(cfg, quantize_params_static(random_dense_params(cfg, seed),
                                           cfg), device="cpu")


def _run(model, seed):
    rng = np.random.default_rng(seed)
    x_t, x_c = (torch.from_numpy(rng.standard_normal((2, 130, C),
                                                     dtype=np.float32))
                for _ in range(2))
    return model(x_t, torch.tensor([0.3, 0.8]), x_c)


def _is_t(copy, w):
    return (copy.dtype == torch.int8 and copy.is_contiguous()
            and torch.equal(copy, w.t()))


@pytest.mark.parametrize("knobs,full", [
    ({}, False), (PROLOGUE, False), ({"fused_mlp_impl": "full"}, True),
    ({**PROLOGUE, "flash_fused_out": True, "fused_mlp_impl": "full",
      "int8_impl": "pallas"}, True)],
    ids=["half", "half_prologue", "full", "all_three"])
def test_mlp_out_kmajor_copy_exactly_under_the_full_mlp(knobs, full,
                                                        monkeypatch):
    """``mlp_out_kernel_t`` is ``mlp_out.kernel_q.t()`` where the whole MLP
    runs and None elsewhere; it stays out of the state dict, and every
    ``int8_mlp`` call gets both of its block's copies."""
    model = _model(30, **knobs)
    for blk in model.blocks:
        t = blk.mlp_out_kernel_t
        assert (t is not None) == full
        if full:
            assert _is_t(t, blk.mlp_out.kernel_q)
        assert _is_t(blk.mlp_in_kernel_t, blk.mlp_in.kernel_q)
    assert not [k for k in model.state_dict() if k.endswith("kernel_t")]
    mlp = Spy(monkeypatch, "int8_mlp")
    _run(model, 31)
    assert len(mlp.calls) == (len(model.blocks) if full else 0)
    assert [(kw["w1_t"], kw["w2_t"]) for _, kw in mlp.calls] == [
        (b.mlp_in_kernel_t, b.mlp_out_kernel_t)
        for b in model.blocks][:len(mlp.calls)]


@pytest.mark.parametrize("knobs,mlp_in_calls", [
    ({}, True), (PROLOGUE, False), ({"fused_mlp_impl": "full"}, False)],
    ids=["half", "half_prologue", "full"])
def test_patch_embed_and_mlp_in_hand_b5_their_kmajor_copies(knobs,
                                                            mlp_in_calls,
                                                            monkeypatch):
    """The patch embed's copy is ``patch_in.kernel_q.t()`` (``[512, 512]``
    here, ``[512, 8192]`` at v3), made once and out of the state dict; B5
    gets it for the patch embed, and mlp_in's copy for every block's
    mlp_in where the unfused half MLP runs."""
    model = _model(32, **knobs)
    assert _is_t(model.patch_in_kernel_t, model.patch_in.kernel_q)
    assert "patch_in_kernel_t" not in model.state_dict()
    dgq = Spy(monkeypatch, "int8_dense_gelu_quant")
    _run(model, 33)
    want = [model.patch_in_kernel_t] + (
        [b.mlp_in_kernel_t for b in model.blocks] if mlp_in_calls else [])
    assert [kw["w_t"] for _, kw in dgq.calls] == want


@pytest.mark.parametrize("N1", [1024, 2560, 5120])
@pytest.mark.parametrize("M", [2070, 2112, 100])
def test_mlp_plan_covers_every_row_slab_and_tile_once(M, N1):
    """At v3's H (1280) and mlp_in widths 1024, 2560 and 5120 (one, two and
    four slabs), M the second path's rows, the third path's and a short
    input: each (row < M, slab, column tile) once, column tile t on
    warpgroup t % 2, every slab 128-aligned; the hidden CTA's shared memory
    fits; the second product's grid covers [M, N2] (192 x 128 tiles)."""
    H = 1280
    p = mlp_plan(M, H, N1, H)
    assert p.slab * p.n_slabs == N1 and p.slab % 128 == 0
    assert p.tiles * 128 == p.slab
    seen = list(p.hidden_cover())
    cells = [(r, j, t) for _, _, r, j, t in seen]
    assert len(cells) == len(set(cells)) == M * p.n_slabs * p.tiles
    assert set(cells) == {(r, j, t) for r in range(M)
                          for j in range(p.n_slabs) for t in range(p.tiles)}
    assert all(wg == t % 2 for _, wg, _, _, t in seen)
    assert all(cta[0] == j and cta[1] == r // p.hidden_rows
               for cta, _, r, j, _ in seen)
    assert p.hidden_smem <= _SMEM_LIMIT
    assert p.out_grid == (H // 128, -(-M // p.out_rows))
    if (M, N1) == (2112, 5120):  # v3: both products in one wave of 132 SMs
        assert p.hidden_grid == (4, 33) and p.n_slabs == 4
        assert p.out_grid == (10, 11)


@pytest.mark.parametrize("K,N1,N2,what", [
    (4224, 5120, 1280, "K"), (1280, 128 * 67, 1280, "slab"),
    (1280, 5120, 200, "N2"), (1216, 5120, 1280, "K")])
def test_mlp_plan_raises_outside_the_kernels(K, N1, N2, what):
    """K past 4096 (the quant keeps a row in registers) or not a multiple
    of 128, a slab wider than 1280 (67 x 128 has no narrower one), or N2
    off 128: ValueError, before any launch."""
    with pytest.raises(ValueError, match="slab" if what == "slab" else "K"):
        mlp_plan(100, K, N1, N2)


def test_wrappers_check_their_kmajor_copies_on_the_cpu():
    """A copy of the wrong shape raises on the CPU as on the card; a right
    one changes nothing of the plain versions' results."""
    rng = np.random.default_rng(34)
    a = torch.from_numpy(rng.standard_normal((40, 256),
                                             dtype=np.float32)).bfloat16()
    w1 = torch.from_numpy(rng.integers(-127, 128, (256, 512), dtype=np.int8))
    w2 = torch.from_numpy(rng.integers(-127, 128, (512, 256), dtype=np.int8))
    s1 = torch.full((1, 512), 1e-3)
    s2 = torch.full((1, 256), 1e-3)
    b1, b2 = torch.zeros((1, 512)), torch.zeros((1, 256))
    with pytest.raises(ValueError, match="w_t"):
        int8_dense_gelu_quant(a, w1, s1, b1, w_t=w1)
    with pytest.raises(ValueError, match="w_t"):
        int8_mlp(a, w1, s1, b1, w2, s2, b2, w1_t=w1.t().contiguous(), w2_t=w2)
    got = int8_dense_gelu_quant(a, w1, s1, b1, w_t=w1.t().contiguous())
    want = int8_dense_gelu_quant(a, w1, s1, b1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kt = {"w1_t": w1.t().contiguous(), "w2_t": w2.t().contiguous()}
    assert torch.equal(int8_mlp(a, w1, s1, b1, w2, s2, b2, **kt),
                       int8_mlp(a, w1, s1, b1, w2, s2, b2))
