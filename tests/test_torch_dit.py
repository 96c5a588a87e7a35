"""The port's int8 serving DiT against the JAX ``DiT.apply``.

A narrow config (hidden 128, depth 2, 4/2 heads, bottleneck 128, T=130 so
the patch count pads) on the serving branches: int8_static, fused QKV, flash
QKV attention, "half" fused MLP, fused patch embed, without the fused
prologue and with it (``fused_prologue`` and ``align_n``: 33 patches padded
to 40, keys masked past 33).  The JAX kernels run in interpret mode.

Tolerances.  Every int8 product is exact on both sides, but each dynamic
activation quantisation can flip a code by one where a bf16 value below
it differs by one ulp between the frameworks (exp2, rsqrt, tanh and
summation order differ in the last fp32 bit).  One flipped code moves its
dot by 1/127 of that element's scale, so the outputs agree to a few bf16
ulps: max error 1.6e-2 (4 ulps of a bf16 in [0.5, 1)) and mean error
1.5e-3, on outputs of mean magnitude ~0.19 (measured: 7.8e-3 and 5.4e-4).
The AdaLN tables are one bf16 product and one bf16 add from the same fp32
time embedding: within 2 bf16 ulps (rtol 1e-2, atol 1e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.models.dit import adaln_tables as jax_adaln_tables
from jatsr_torch.models.dit import adaln_tables
from jatsr_torch.ops.quant import quantize_params_static
from jatsr_torch.configs import get_preset
from jatsr_torch.models.from_jax import random_dense_params

from torch_parity import C, Spy, build_pair, narrow_cfg, to_numpy_tree


def _inputs(seed, B=2, T=130):
    rng = np.random.default_rng(seed)
    x_t = rng.standard_normal((B, T, C), dtype=np.float32)
    x_c = rng.standard_normal((B, T, C), dtype=np.float32)
    t = rng.uniform(0.0, 1.0, (B,)).astype(np.float32)
    return x_t, t, x_c


def _assert_close(got, want, mean=1.5e-3):
    err = np.abs(got - want)
    assert err.max() <= 1.6e-2, err.max()
    assert err.mean() <= mean, err.mean()


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_dit_forward_matches_jax(norm):
    jmodel, jparams, tmodel, _ = build_pair(norm)
    x_t, t, x_c = _inputs(seed=1)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert got.dtype == torch.float32 and got.shape == x_t.shape
    assert np.abs(np.asarray(want)).mean() > 0.05  # not the identity / zero
    _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_dit_hoisted_adaln_matches_jax(norm):
    """The serving call: AdaLN tables hoisted per step, shared over batch."""
    jmodel, jparams, tmodel, _ = build_pair(norm, seed=2)
    x_t, _, x_c = _inputs(seed=3)
    t1 = np.array([0.375], np.float32)
    jt = jax_adaln_tables(jmodel.cfg, jparams, jnp.asarray(t1))
    tt = adaln_tables(tmodel, torch.from_numpy(t1))
    assert tt.shape == (2, 1, 6 * 128) and tt.dtype == torch.bfloat16
    np.testing.assert_allclose(tt.float().numpy(), np.asarray(jt, np.float32),
                               rtol=1e-2, atol=1e-3)
    t = np.full((2,), 0.375, np.float32)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c), adaln_mod=jt)
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c), adaln_mod=tt)
    _assert_close(got.numpy(), np.asarray(want))


def test_quantize_params_static_matches_jax():
    """The numpy quantizer gives the JAX tree bit for bit (fused qkv)."""
    _, jparams, tmodel, dense = build_pair("layer", seed=4)
    ours = quantize_params_static(dense, tmodel.cfg)
    theirs = to_numpy_tree(jparams)

    def walk(a, b, path=""):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(
                    np.asarray(a[k], np.float32), np.asarray(b[k], np.float32),
                    err_msg=f"{path}/{k}")
    walk(ours, theirs)


@pytest.mark.parametrize("knob,value", [
    ("matmul_precision", "bf16"), ("matmul_precision", "int8"),
    ("dtype", "float16"),
])
def test_dit_raises_outside_the_slice(knob, value):
    """What the int8 DiT still raises for: a compute dtype other than bf16
    and fp32 (at fp32 every branch serves: ``tests/test_torch_f32_modes.py``),
    and a precision other than int8_static, whose models are DenseDiT's."""
    import dataclasses

    from jatsr_torch.models.dit import DiT

    cfg = dataclasses.replace(narrow_cfg(get_preset), **{knob: value})
    static = quantize_params_static(random_dense_params(cfg), cfg)
    with pytest.raises(NotImplementedError, match=knob):
        DiT(cfg, static, device="cpu")


@pytest.mark.parametrize("knobs", [
    {"quantize_head": True},
    {"pos_embed": "learned", "attention_bias": True},
    {"fused_qkv": False},
    {"fused_mlp": False},
    {"flash_int8_qk": True},
], ids=["quantize_head", "pos_embed", "fused_qkv", "fused_mlp",
        "flash_int8_qk"])
def test_served_knob_matches_jax(knobs, monkeypatch):
    """Each serving knob the int8 DiT once raised for, alone on the narrow
    DiT (33 patches), against JAX ``DiT.apply`` on the same weights, each
    side quantizing them for the knob's layout: both reach the same kernels
    and agree within the code-flip tolerance (with the int8 head, a
    flipped code of the head's activation moves an output directly, so its
    mean bound is 2.5e-3; measured 1.1e-3).  ``flash_int8_qk`` is B2 with
    its s8 value product; learned positions (with attention biases) leave
    the flash-QKV kernel for the split one."""
    jmodel, jparams, tmodel, _ = _build_knobs(knobs, seed=40)
    jax_spies, port_spies = _spy_kernels(monkeypatch)
    x_t, t, x_c = _inputs(seed=41)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert _reached(port_spies) == _reached(jax_spies)
    if "flash_int8_qk" in knobs:
        assert [kw["int8_qk"] for _, kw in
                port_spies["gqa_attention_flash_qkv"].calls] == [True] * 2
    assert np.abs(np.asarray(want)).mean() > 0.05
    _assert_close(got.numpy(), np.asarray(want),
                  mean=2.5e-3 if "quantize_head" in knobs else 1.5e-3)


def _build_knobs(knobs, seed, norm="rms"):
    """The narrow pair with ``knobs`` replaced on top (knobs
    ``narrow_cfg`` itself sets included): (jax model, its static params,
    port model, dense params)."""
    import dataclasses

    import jax

    from jatsr_tpu.configs import get_preset as jax_get_preset
    from jatsr_tpu.models import DiT as JaxDiT
    from jatsr_tpu.ops.quant import quantize_params_static as jax_quantize
    from jatsr_torch.models.dit import DiT

    jcfg = dataclasses.replace(narrow_cfg(jax_get_preset, norm), **knobs)
    tcfg = dataclasses.replace(narrow_cfg(get_preset, norm), **knobs)
    dense = random_dense_params(tcfg, seed)
    jmodel = JaxDiT(jcfg)
    x = jnp.zeros((1, 8, C), jnp.float32)
    shape = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                            jnp.zeros((1,)), x)["params"])
    jparams = jax_quantize(jax.tree_util.tree_map(jnp.asarray, dense), shape)
    tmodel = DiT(tcfg, quantize_params_static(dense, tcfg), device="cpu")
    return jmodel, jparams, tmodel, dense


PROLOGUE = dict(fused_prologue=True, align_n=True)


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_prologue_dit_forward_matches_jax(norm, monkeypatch):
    """T = 130 frames: 33 patches, padded to 40 by align_n; the blocks take
    the fused prologue (B3, B4, B1) and attention masks keys past 33."""
    jmodel, jparams, tmodel, _ = build_pair(norm, seed=6, **PROLOGUE)
    attn = Spy(monkeypatch, "gqa_attention_flash_qkv")
    qkv = Spy(monkeypatch, "int8_norm_mod_dot")
    out = Spy(monkeypatch, "int8_matmul_fused")
    mlp = Spy(monkeypatch, "int8_norm_mod_dense_gelu_quant")
    x_t, t, x_c = _inputs(seed=7)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert got.shape == x_t.shape
    assert [(a[0].shape[1], kw["n_valid"]) for a, kw in attn.calls] == \
        [(40, 33)] * 2
    assert len(qkv.calls) == len(out.calls) == len(mlp.calls) == 2
    assert qkv.calls[0][0][1].shape == (2, 128)  # per-sample rows, fp32
    assert np.abs(np.asarray(want)).mean() > 0.05
    _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_prologue_dit_hoisted_adaln_matches_jax(norm, monkeypatch):
    """The serving call with ``[depth, 1, 6H]`` tables: one modulation row
    shared over the batch reaches the prologue kernels as ``[1, H]``."""
    jmodel, jparams, tmodel, _ = build_pair(norm, seed=8, **PROLOGUE)
    qkv = Spy(monkeypatch, "int8_norm_mod_dot")
    x_t, _, x_c = _inputs(seed=9, B=3)
    t1 = np.array([0.625], np.float32)
    jt = jax_adaln_tables(jmodel.cfg, jparams, jnp.asarray(t1))
    tt = adaln_tables(tmodel, torch.from_numpy(t1))
    assert tt.shape == (2, 1, 6 * 128)
    t = np.full((3,), 0.625, np.float32)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c), adaln_mod=jt)
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c), adaln_mod=tt)
    assert qkv.calls[0][0][1].shape == (1, 128)
    _assert_close(got.numpy(), np.asarray(want))


def test_kmajor_kernels_are_the_transposed_jax_kernels(monkeypatch):
    """The serving DiT keeps the qkv and mlp_in int8 kernels a second time
    K-major (``[N, H]``, contiguous), made once where it registers its
    quantized buffers: the s8 ``wgmma`` GEMM of the fused-prologue kernels
    reads 8-bit operands K-major only.  In a model built from the JAX
    package's quantized parameters they equal ``kernel_q.t()``, stay out of
    the state dict, and are what the fused prologue passes as ``w_t``."""
    from jatsr_torch.models.dit import DiT

    _, jparams, _, _ = build_pair("layer", seed=10, **PROLOGUE)
    cfg = narrow_cfg(get_preset, "layer", **PROLOGUE)
    model = DiT(cfg, to_numpy_tree(jparams), device="cpu")
    for blk in model.blocks:
        for t, w in ((blk.attn.qkv_kernel_t, blk.attn.qkv_proj.kernel_q),
                     (blk.mlp_in_kernel_t, blk.mlp_in.kernel_q)):
            assert t.dtype == torch.int8 and t.is_contiguous()
            assert torch.equal(t, w.t())
    assert not [k for k in model.state_dict() if k.endswith("kernel_t")]
    qkv = Spy(monkeypatch, "int8_norm_mod_dot")
    mlp = Spy(monkeypatch, "int8_norm_mod_dense_gelu_quant")
    x_t, t, x_c = _inputs(seed=11)
    model(torch.from_numpy(x_t), torch.from_numpy(t), torch.from_numpy(x_c))
    assert [kw["w_t"] for _, kw in qkv.calls] == [
        b.attn.qkv_kernel_t for b in model.blocks]
    assert [kw["w_t"] for _, kw in mlp.calls] == [
        b.mlp_in_kernel_t for b in model.blocks]


def test_out_projection_keeps_its_kmajor_kernel(monkeypatch):
    """B4, the fused out projection, reads out_proj's kernel K-major on the
    card: the fused-prologue DiT keeps it a second time as ``out_kernel_t``
    (``[N, K]``, equal to ``kernel_q.t()``, contiguous, not in the state
    dict), made once at construction, and passes that very tensor to every
    ``int8_matmul_fused`` call.  A ``QuantDense`` keeps ``kernel_t`` with
    ``int8_impl="fused"`` only, and the DiT's copy is then out_proj's own."""
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.ops.quant import QuantDense

    cfg = narrow_cfg(get_preset, "layer", **PROLOGUE)
    params = quantize_params_static(random_dense_params(cfg, 12), cfg)
    model = DiT(cfg, params, device="cpu")
    for blk in model.blocks:
        t, w = blk.attn.out_kernel_t, blk.attn.out_proj.kernel_q
        assert t.dtype == torch.int8 and t.is_contiguous()
        assert torch.equal(t, w.t())
        assert blk.attn.out_proj.kernel_t is None  # int8_impl "xla"
    assert not [k for k in model.state_dict() if k.endswith("kernel_t")]
    out = Spy(monkeypatch, "int8_matmul_fused")
    x_t, t, x_c = _inputs(seed=13)
    model(torch.from_numpy(x_t), torch.from_numpy(t), torch.from_numpy(x_c))
    assert [kw["w_t"] for _, kw in out.calls] == [
        b.attn.out_kernel_t for b in model.blocks]
    fused = DiT(dataclasses.replace(cfg, int8_impl="fused"), params,
                device="cpu")
    for blk in fused.blocks:
        for proj in (blk.attn.qkv_proj, blk.attn.out_proj):
            assert isinstance(proj, QuantDense)
            assert torch.equal(proj.kernel_t, proj.kernel_q.t())
            assert proj.kernel_t.is_contiguous()
        assert blk.attn.out_kernel_t is blk.attn.out_proj.kernel_t
    plain = DiT(narrow_cfg(get_preset, "layer"), params, device="cpu")
    assert all(b.attn.out_kernel_t is None for b in plain.blocks)


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_each_weight_is_held_kmajor_once(impl):
    """Under ``int8_impl`` "pallas" and "fused" the qkv and out
    projections' QuantDense keep their kernel K-major (``kernel_t``), and
    the DiT's copies are those very tensors: ``qkv_kernel_t`` is
    ``qkv_proj.kernel_t``, and with flash_fused_out (B12, head dim 32: no
    padding) ``out_kernel_t`` is ``out_proj.kernel_t``."""
    from jatsr_torch.models.dit import DiT

    cfg = narrow_cfg(get_preset, "layer", **PROLOGUE, **dict(
        OPT_IN, int8_impl=impl))
    model = DiT(cfg, quantize_params_static(random_dense_params(cfg, 14),
                                            cfg), device="cpu")
    for blk in model.blocks:
        a = blk.attn
        for t, proj in ((a.qkv_kernel_t, a.qkv_proj),
                        (a.out_kernel_t, a.out_proj)):
            assert t is proj.kernel_t
            assert t.untyped_storage().data_ptr() == \
                proj.kernel_t.untyped_storage().data_ptr()
            assert torch.equal(t, proj.kernel_q.t()) and t.is_contiguous()
    assert not [k for k in model.state_dict() if k.endswith("kernel_t")]


def test_flash_out_dit_keeps_the_padded_kmajor_out_projection(monkeypatch):
    """Where flash_fused_out can take B12 the DiT makes ``out_kernel_t``
    once, with or without the fused prologue; at head dim 48 (hidden 384,
    8/4 heads) it is the padded ``pad_heads(wo_q.t(), 48, 64)``, contiguous,
    which the DiT hands to every B12 call; the output matches the JAX
    model's.  Without flash_qkv (no B12) there is none."""
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.ops.attention import pad_heads

    knobs = dict(flash_fused_out=True, int8_impl="pallas")
    jmodel, jparams, tmodel, dense = build_pair(
        "rms", seed=15, hidden_size=384, num_q_heads=8, num_kv_heads=4,
        **knobs)
    assert tmodel.cfg.head_dim == 48
    for blk in tmodel.blocks:
        wo_q = blk.attn.out_proj.kernel_q
        t = blk.attn.out_kernel_t
        assert t.shape == (384, 8 * 64) and t.is_contiguous()
        assert torch.equal(t, pad_heads(wo_q.t(), 48, 64))
    out = Spy(monkeypatch, "gqa_attention_flash_out")
    x_t, t, x_c = _inputs(seed=16)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert [kw["wo_t"] for _, kw in out.calls] == [
        b.attn.out_kernel_t for b in tmodel.blocks]
    _assert_close(got.numpy(), np.asarray(want))
    cfg = tmodel.cfg
    static = quantize_params_static(dense, cfg)
    no_b12 = DiT(dataclasses.replace(cfg, flash_qkv=False), static,
                 device="cpu")
    assert all(b.attn.out_kernel_t is None for b in no_b12.blocks)
    narrow = narrow_cfg(get_preset, "rms", flash_fused_out=True)
    plain = DiT(narrow, quantize_params_static(
        random_dense_params(narrow, 15), narrow), device="cpu")
    for blk in plain.blocks:  # int8_impl "xla": the DiT's own copy
        assert blk.attn.out_proj.kernel_t is None
        assert torch.equal(blk.attn.out_kernel_t,
                           blk.attn.out_proj.kernel_q.t())


def test_prologue_without_align_n_takes_the_unfused_branch(monkeypatch):
    """fused_prologue on, align_n off: 33 patches have no 8-aligned row
    block, so JAX silently takes the unfused branch, and so does the port."""
    jmodel, jparams, tmodel, _ = build_pair("rms", seed=10,
                                            fused_prologue=True)
    qkv = Spy(monkeypatch, "int8_norm_mod_dot")
    attn = Spy(monkeypatch, "gqa_attention_flash_qkv")
    x_t, t, x_c = _inputs(seed=11)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert not qkv.calls
    assert [(a[0].shape[1], kw["n_valid"]) for a, kw in attn.calls] == \
        [(33, 0)] * 2
    _assert_close(got.numpy(), np.asarray(want))


def test_int8_impl_fused_matches_jax():
    """``int8_impl="fused"`` without the prologue: qkv_proj and out_proj are
    QuantDense with the fused W8A8 product, the plain path on the CPU."""
    jmodel, jparams, tmodel, _ = build_pair("layer", seed=12,
                                            int8_impl="fused")
    assert tmodel.blocks[0].attn.out_proj.int8_impl == "fused"
    x_t, t, x_c = _inputs(seed=13)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    _assert_close(got.numpy(), np.asarray(want))


# The kernels a serving forward can reach, where each side looks them up at
# call time: the JAX model imports them inside its functions, the port's
# DiT from its own module, and both QuantDense classes call their module's
# w8a8_dot (recorded with its impl).
_KERNELS = ("int8_norm_mod_dot", "int8_norm_mod_dense_gelu_quant",
            "int8_matmul_fused", "int8_dense_gelu_quant", "int8_mlp",
            "gqa_attention_flash_qkv", "gqa_attention_flash_out",
            "gqa_attention_flash", "gqa_attention", "gqa_attention_grouped")


def _spy_kernels(monkeypatch):
    import jatsr_torch.ops.quant as tquant
    from jatsr_tpu.ops import attention as jattn
    from jatsr_tpu.ops import int8_matmul as jmm
    from jatsr_tpu.ops import quant as jquant

    def spies(module_of):
        out = {n: Spy(monkeypatch, n, module_of(n)) for n in _KERNELS}
        out["w8a8_dot"] = Spy(monkeypatch, "w8a8_dot", module_of("w8a8_dot"))
        return out

    return (spies(lambda n: jquant if n == "w8a8_dot" else
                  jattn if n.startswith("gqa") else jmm),
            spies(lambda n: tquant if n == "w8a8_dot" else None))


def _reached(spies):
    """The kernels a forward called, and the impls its QuantDenses used."""
    return ({n for n in _KERNELS if spies[n].calls},
            {kw["impl"] for _, kw in spies["w8a8_dot"].calls})


_HALF_PROLOGUE = {"int8_norm_mod_dot", "gqa_attention_flash_qkv",
                  "int8_matmul_fused", "int8_norm_mod_dense_gelu_quant",
                  "int8_dense_gelu_quant"}
OPT_IN = dict(flash_fused_out=True, fused_mlp_impl="full", int8_impl="pallas")


@pytest.mark.parametrize("knobs,kernels,impls", [
    ({}, _HALF_PROLOGUE, set()),
    (OPT_IN, {"gqa_attention_flash_out", "int8_mlp", "int8_dense_gelu_quant"},
     {"pallas"}),
    ({"flash_fused_out": True},
     {"gqa_attention_flash_out", "int8_dense_gelu_quant"}, {"xla"}),
    ({"fused_mlp_impl": "full"},
     {"gqa_attention_flash_qkv", "int8_mlp", "int8_dense_gelu_quant"},
     {"xla"}),
    ({"int8_impl": "pallas"}, _HALF_PROLOGUE, set()),
], ids=["default", "all_three", "flash_out", "full_mlp", "int8_pallas"])
def test_opt_in_knobs_take_the_jax_branch(knobs, kernels, impls, monkeypatch):
    """On top of bench.py's default DiT (fused prologue, align_n: 33 patches
    aligned to 40), each opt-in knob alone and all three together.  Either
    of flash_fused_out and fused_mlp_impl="full" turns the fused prologue
    off on both sides (``fused_prologue_taken``); int8_impl="pallas" alone
    keeps it, so no QuantDense runs.  The port reaches the kernels the JAX
    model reaches, and matches its output."""
    jmodel, jparams, tmodel, _ = build_pair("rms", seed=20, **PROLOGUE,
                                            **knobs)
    jax_spies, port_spies = _spy_kernels(monkeypatch)
    x_t, t, x_c = _inputs(seed=21)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert _reached(port_spies) == _reached(jax_spies) == (kernels, impls)
    if "gqa_attention_flash_out" in kernels:
        assert [(a[0].shape[1], kw["n_valid"]) for a, kw in
                port_spies["gqa_attention_flash_out"].calls] == [(40, 33)] * 2
    assert np.abs(np.asarray(want)).mean() > 0.05
    _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_opt_in_dit_hoisted_adaln_matches_jax(norm):
    """All three opt-in knobs under the serving call's ``[depth, 1, 6H]``
    tables, both norms, at B = 3."""
    jmodel, jparams, tmodel, _ = build_pair(norm, seed=22, **PROLOGUE,
                                            **OPT_IN)
    x_t, _, x_c = _inputs(seed=23, B=3)
    t1 = np.array([0.625], np.float32)
    jt = jax_adaln_tables(jmodel.cfg, jparams, jnp.asarray(t1))
    tt = adaln_tables(tmodel, torch.from_numpy(t1))
    t = np.full((3,), 0.625, np.float32)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c), adaln_mod=jt)
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c), adaln_mod=tt)
    _assert_close(got.numpy(), np.asarray(want))


def _run_pair(knobs, seed, monkeypatch, norm="rms"):
    """The narrow pair under ``knobs``, spied on both sides: (JAX reached,
    port reached, JAX spies, port spies), after holding the outputs within
    ``_assert_close``."""
    jmodel, jparams, tmodel, _ = build_pair(norm, seed=seed, **knobs)
    jax_spies, port_spies = _spy_kernels(monkeypatch)
    x_t, t, x_c = _inputs(seed=seed + 1)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert np.abs(np.asarray(want)).mean() > 0.05
    _assert_close(got.numpy(), np.asarray(want))
    return _reached(jax_spies), _reached(port_spies), jax_spies, port_spies


_SPLIT = ("gqa_attention_flash", "gqa_attention", "gqa_attention_grouped")


def _rows(spies):
    """The patch counts the split attention kernels were given."""
    return {a[0].shape[1] for n in _SPLIT for a, _ in spies[n].calls}


@pytest.mark.parametrize("knobs,kernel", [
    ({"flash_qkv": False}, "gqa_attention_flash"),
    ({"attention_impl": "pallas"}, "gqa_attention"),
    ({"attention_impl": "pallas2"}, "gqa_attention_grouped"),
    ({"attention_impl": "xla", "scores_dtype": "float32"}, None),
    ({"attention_impl": "xla", "scores_dtype": "bfloat16"}, None),
], ids=["split_flash", "pallas", "pallas2", "xla_f32", "xla_bf16"])
def test_split_attention_knobs_take_the_jax_branch(knobs, kernel,
                                                   monkeypatch):
    """The split q/k/v branch: qkv_proj, bf16 RoPE, then the split flash
    kernel, the per-q-head or per-kv-head kernel, or the einsum (either
    score dtype), and out_proj.  Both sides reach the same kernels (33
    patches, unpadded) and agree."""
    jax_got, port_got, jax_spies, port_spies = _run_pair(knobs, 30,
                                                         monkeypatch)
    kernels = {"int8_dense_gelu_quant"} | ({kernel} if kernel else set())
    assert port_got == jax_got == (kernels, {"xla"})
    assert _rows(port_spies) == _rows(jax_spies) == \
        ({33} if kernel else set())


def test_no_flash_qkv_neither_aligns_nor_masks(monkeypatch):
    """bench.py --no-flash-qkv: the fused prologue and align_n are asked
    for, but the JAX model takes neither without flash_qkv, so the blocks
    run the split flash kernel on the 33 real patches, no key masked."""
    jax_got, port_got, jax_spies, port_spies = _run_pair(
        dict(PROLOGUE, flash_qkv=False), 32, monkeypatch)
    assert port_got == jax_got == ({"gqa_attention_flash",
                                    "int8_dense_gelu_quant"}, {"xla"})
    assert _rows(port_spies) == _rows(jax_spies) == {33}


def test_flash_fused_out_needs_flash_qkv(monkeypatch):
    """flash_fused_out with flash_qkv=False: the JAX model takes the fused
    out projection only inside its flash-QKV branch, so both sides run the
    split flash kernel and the QuantDense out_proj."""
    jax_got, port_got, _, _ = _run_pair(
        dict(PROLOGUE, flash_fused_out=True, flash_qkv=False), 34,
        monkeypatch)
    assert port_got == jax_got == ({"gqa_attention_flash",
                                    "int8_dense_gelu_quant"}, {"xla"})


@pytest.mark.parametrize("knobs,kernels", [
    (dict(PROLOGUE, attention_impl="pallas"),
     {"gqa_attention", "int8_dense_gelu_quant"}),
    (PROLOGUE, {"int8_norm_mod_dot", "int8_norm_mod_dense_gelu_quant",
                "int8_dense_gelu_quant"}),
], ids=["pallas", "flash"])
def test_past_the_flash_budget(knobs, kernels, monkeypatch):
    """With ``flash_supported`` forced to False on both sides (as past ~1000
    patches): the pallas kernels have no budget gate, so "pallas" still
    reaches the per-q-head kernel; "flash" leaves both flash kernels for the
    einsum (bench.py's default: the prologue kernels stay, the padded keys
    of align_n go unmasked as in JAX).  The port no longer raises there."""
    import jatsr_torch.models.dit as tdit
    from jatsr_tpu.ops import attention as jattn

    for module in (jattn, tdit):
        monkeypatch.setattr(module, "flash_supported", lambda *a: False)
    jax_got, port_got, _, _ = _run_pair(knobs, 36, monkeypatch)
    assert port_got == jax_got == (kernels, {"xla"})
