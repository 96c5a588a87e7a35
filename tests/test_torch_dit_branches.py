"""The int8 DiT's serving branches past the fused ones, and the dynamic
W8A8 model, against the JAX package on the CPU.

The narrow DiT of ``torch_parity.py`` (hidden 128, depth 2, 4/2 heads,
T = 130 frames: 33 patches) with knobs on top: q/k/v projections apart
(``fused_qkv=False``), the unfused QuantDense MLP (``fused_mlp=False``),
the unfused patch embed (bottleneck 64, as ``tiny``'s), the int8 head
(``quantize_head``), learned positions with attention biases at G = 1
(``v1legacy``'s layout), each under every ``int8_impl`` it reaches; and
``DenseDiT`` under ``matmul_precision="int8"`` (every projection the JAX
model's ``mk`` makes through ``int8_dot_general``).  Both sides quantize
the same dense weights, each with its own ``quantize_params_static`` (or,
dynamic, at every call).

Tolerances.  ``int8_dot_general`` and ``quantize_params_static`` are bit
for bit.  The models agree within ``test_torch_dit.py``'s code-flip bounds
(max 1.6e-2, mean 1.5e-3 on outputs of mean magnitude ~0.19), but where
the head is int8 (a flipped code of its activation moves an output
directly): mean 2.5e-3.  The dynamic model is bit-equal to the static one
where both take the same routes: the same codes, products and rescales.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.ops import quant as jquant
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DenseDiT, DiT, check_training_config
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.ops import quant as tquant
from jatsr_torch.ops.quant import int8_dot_general, quantize_params_static

from test_torch_dit import (_assert_close, _build_knobs, _inputs, _reached,
                            _spy_kernels)
from torch_parity import C, narrow_cfg, to_numpy_tree

BRANCHES = {
    "split_qkv": {"fused_qkv": False},
    "unfused_mlp": {"fused_mlp": False},
    "unfused_patch": {"bottleneck_dim": 64},
    "int8_head": {"quantize_head": True, "fused_mlp": False},
}


def _forward(jmodel, jparams, tmodel, seed):
    x_t, t, x_c = _inputs(seed)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert np.abs(np.asarray(want)).mean() > 0.05
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_matches_jax_under_each_int8_impl(branch, impl, monkeypatch):
    """Each branch under each ``int8_impl``: both sides reach the same
    kernels and the same ``w8a8_dot`` impls (the QuantDense products of
    the branch), and agree."""
    knobs = dict(BRANCHES[branch], int8_impl=impl)
    jmodel, jparams, tmodel, _ = _build_knobs(knobs, seed=50)
    jax_spies, port_spies = _spy_kernels(monkeypatch)
    got, want = _forward(jmodel, jparams, tmodel, 51)
    kernels, impls = _reached(port_spies)
    assert (kernels, impls) == _reached(jax_spies)
    assert impls == {impl}
    if branch == "unfused_patch":  # B5 still runs every block's mlp_in
        assert tmodel.patch_in_kernel_t is None and not tmodel.fused_patch
    _assert_close(got, want, mean=2.5e-3 if branch == "int8_head" else 1.5e-3)


def test_learned_positions_at_one_group_match_jax(monkeypatch):
    """v1legacy's layout (learned positions, attention biases, q-heads =
    kv-heads: G = 1) with bench.py's fused knobs: the fused prologue and
    the flash-QKV kernel are not taken (no RoPE), so the blocks split the
    fused projection and run the split flash kernel with no rotation; the
    patch embed and every mlp_in run B5; ``pos_embed`` [max_len, H] is
    added after the patch embed."""
    knobs = dict(pos_embed="learned", attention_bias=True, num_kv_heads=4,
                 fused_prologue=True, align_n=True)
    jmodel, jparams, tmodel, dense = _build_knobs(knobs, seed=52)
    assert dense["pos_embed"].shape == (tmodel.cfg.max_len, 128)
    assert torch.equal(tmodel.pos_embed, torch.from_numpy(dense["pos_embed"]))
    jax_spies, port_spies = _spy_kernels(monkeypatch)
    got, want = _forward(jmodel, jparams, tmodel, 53)
    assert _reached(port_spies) == _reached(jax_spies) == (
        {"gqa_attention_flash", "int8_dense_gelu_quant"}, {"xla"})
    _assert_close(got, want)


@pytest.mark.parametrize("fused_qkv,quantize_head,pos_embed", [
    (True, False, "rope"), (False, False, "rope"), (True, True, "rope"),
    (False, True, "learned")])
def test_quantize_params_static_is_jax_bit_for_bit(fused_qkv, quantize_head,
                                                   pos_embed):
    """The port's quantizer by config against JAX's for the static model's
    tree: q/k/v merged or apart, ``final_proj`` int8 under
    ``quantize_head``, ``pos_embed`` passed through; every leaf equal."""
    knobs = dict(fused_qkv=fused_qkv, quantize_head=quantize_head,
                 pos_embed=pos_embed, attention_bias=pos_embed == "learned")
    jcfg = dataclasses.replace(narrow_cfg(jax_get_preset), **knobs)
    tcfg = dataclasses.replace(narrow_cfg(get_preset), **knobs)
    dense = random_dense_params(tcfg, 54)
    x = jnp.zeros((1, 8, C), jnp.float32)
    shape = jax.eval_shape(lambda: JaxDiT(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, x, jnp.zeros((1,)), x)["params"])
    theirs = to_numpy_tree(jquant.quantize_params_static(
        jax.tree_util.tree_map(jnp.asarray, dense), shape))
    ours = quantize_params_static(dense, tcfg)

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
    assert ("kernel_q" in ours["final_proj"]) == quantize_head
    assert ("qkv_proj" in ours["blocks"]["attn"]) == fused_qkv


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
def test_int8_dot_general_is_jax_bit_for_bit(impl):
    """The dynamic W8A8 product on a bf16 activation and a bf16 kernel (as
    flax's Dense hands them over): an all-zero kernel column, an all-zero
    activation row and one below the 1e-12 scale floor included."""
    rng = np.random.default_rng(55)
    x = rng.standard_normal((2, 40, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0
    x[0, 3] = 0.0
    x[1, 5] = 1e-14
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jquant.int8_dot_general(xb, wb, (((2,), (0,)), ((), ())),
                                   impl=impl)
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    tw = torch.from_numpy(np.asarray(wb.astype(jnp.float32))).bfloat16()
    got = int8_dot_general(tx, tw, impl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _dense_pair(knobs, seed):
    """(JAX model on the dense tree, that tree as jnp, DenseDiT on it)."""
    jcfg = dataclasses.replace(narrow_cfg(jax_get_preset), **knobs)
    tcfg = dataclasses.replace(narrow_cfg(get_preset), **knobs)
    dense = random_dense_params(tcfg, seed)
    return (JaxDiT(jcfg), jax.tree_util.tree_map(jnp.asarray, dense),
            DenseDiT(tcfg, dense, device="cpu"), dense)


@pytest.mark.parametrize("impl,quantize_head", [
    ("xla", False), ("pallas", False), ("fused", True)])
def test_dynamic_int8_matches_jax(impl, quantize_head, monkeypatch):
    """``matmul_precision="int8"``: DenseDiT against the JAX model on the
    same dense tree.  Every ``mk`` projection (the patch embed, q/k/v,
    out_proj, the MLP) goes through ``int8_dot_general`` with ``impl`` on
    both sides, ``final_proj`` only under ``quantize_head``; the fused_qkv
    knob selects nothing there (JAX ignores it off int8_static)."""
    knobs = dict(matmul_precision="int8", int8_impl=impl, fused_qkv=True,
                 fused_prologue=True, quantize_head=quantize_head)
    jmodel, jparams, tmodel, _ = _dense_pair(knobs, 56)
    calls = {"jax": [], "port": []}
    for side, module in (("jax", jquant), ("port", tquant)):
        fn = module.w8a8_dot

        def spy(*a, _fn=fn, _side=side, **kw):
            calls[_side].append(kw.get("impl"))
            return _fn(*a, **kw)

        monkeypatch.setattr(module, "w8a8_dot", spy)
    with torch.no_grad():
        got, want = _forward(jmodel, jparams, tmodel, 57)
    # patch_in, patch_out, then q, k, v, out, mlp_in, mlp_out a block
    n = 2 + 6 * 2 + int(quantize_head)
    assert calls["port"] == [impl] * n
    assert sorted(set(calls["jax"])) == [impl]
    _assert_close(got, want, mean=2.5e-3 if quantize_head else 1.5e-3)


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
def test_dynamic_int8_is_the_static_model_bit_for_bit(impl):
    """Where both take the same routes (q/k/v apart, the unfused MLP and
    patch embed, the int8 head, the split flash attention), the dynamic
    model on the dense tree equals the static one on the same tree
    quantized once: bit for bit."""
    knobs = dict(fused_qkv=False, fused_mlp=False, quantize_head=True,
                 int8_impl=impl)
    scfg = dataclasses.replace(narrow_cfg(get_preset), **knobs)
    dense = random_dense_params(scfg, 58)
    static = DiT(scfg, quantize_params_static(dense, scfg), device="cpu")
    dynamic = DenseDiT(dataclasses.replace(scfg, matmul_precision="int8"),
                       dense, device="cpu")
    x_t, t, x_c = (torch.from_numpy(a) for a in _inputs(59))
    with torch.no_grad():
        assert torch.equal(static(x_t, t, x_c), dynamic(x_t, t, x_c))


def test_dense_dit_with_learned_positions_matches_jax():
    """The bf16 model with learned positions and attention biases (the
    v1legacy layout, G = 1): no RoPE, ``pos_embed`` a parameter; its eval
    forward against JAX's within bf16 rounding (rtol 2e-2, atol 2e-2)."""
    knobs = dict(matmul_precision="bf16", pos_embed="learned",
                 attention_bias=True, num_kv_heads=4)
    jmodel, jparams, tmodel, dense = _dense_pair(knobs, 60)
    assert torch.equal(tmodel.pos_embed.detach(),
                       torch.from_numpy(dense["pos_embed"]))
    with torch.no_grad():
        got, want = _forward(jmodel, jparams, tmodel, 61)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_dynamic_int8_does_not_train():
    """Dynamic int8 is a serving mode: the training forward raises."""
    cfg = dataclasses.replace(narrow_cfg(get_preset),
                              matmul_precision="int8", fused_qkv=False)
    model = DenseDiT(cfg, random_dense_params(cfg, 62), device="cpu")
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        check_training_config(cfg)
    x = torch.zeros((1, 8, C))
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        model(x, torch.zeros(1), x, deterministic=False, layer_seeds=[1, 2])
