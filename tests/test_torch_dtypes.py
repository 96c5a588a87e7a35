"""The serving DiT's dtype branches against the JAX package on the CPU:
bf16 parameters (``param_dtype="bfloat16"``, as ``bench.py`` builds every
model), the fp32 compute dtype (``dtype="float32"``) with the fp32 modes of
B1, B2, B3 and B5, and bf16 score storage in training.  The fp32 modes of
B11, B12, B13, B15, B16 and B2's ``int8_qk``, and the fp32 DiT on their
branches, are ``tests/test_torch_f32_modes.py``'s.

- ``DenseDiT`` with bf16 parameters at precision ``bf16`` (``bench.py
  --bf16``: the split flash kernel, B11) and ``int8`` (``--precision int8
  --int8-impl fused``) against ``DiT.apply`` on the same bf16 tree (45
  patches): within 2e-2 x the outputs' max, the bound of
  ``tests/test_torch_train_step.py``'s eval forward (bf16 products of the
  same weights, rounded where each framework rounds them).  The tree goes
  in and comes out bit for bit.
- The int8 ``DiT`` built from a bf16 JAX tree (bf16 biases, AdaLN, t-MLP
  and head; fp32 scales): within ``test_torch_dit.py``'s code-flip bounds
  (max 1.6e-2, mean 1.5e-3).
- The fp32 modes' plain versions against the JAX kernels in interpret mode
  on fp32 inputs.  B3: the prologue's codes and row scales equal to those
  of the JAX kernel's own prologue (``_norm_mod``, then its row quant); the
  fp32 outputs within rtol 1e-6 of the largest (an exact int32 product,
  then ``(acc * s) * ws + b``, which XLA may contract to an FMA: one fp32
  rounding).  B1 and B5: codes equal but for at most 0.5 % off by one
  (``assert_codes_close``, as their bf16 tests), scales within rtol 1e-6.
  B2: rtol = atol = 1e-5 (fp32 products and sums in another order; exp2 in
  each framework's own fp32 form).
- The int8 ``DiT`` at ``dtype="float32"`` (``bench.py``'s default DiT with
  the fused prologue and ``align_n``, and without the prologue) and
  ``DenseDiT`` at fp32 with the einsum attention (precision ``bf16`` and
  ``int8``) against ``DiT.apply``: within ``test_torch_dit.py``'s bounds
  (the int8 products can still flip a code by one where an fp32 statistic
  differs in its last bit).
- fp32 and bf16-parameter models serve and run their training forward
  and backward, each gradient in its parameter's dtype (their steps
  against JAX: ``tests/test_torch_train_f32.py``).
- A train step with ``scores_dtype="bfloat16"`` on the einsum path,
  dropout 0, against JAX's step fed its own draws, under MSE: the bounds of
  ``test_train_steps_match_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.ops import attention as jattn
from jatsr_tpu.ops import int8_matmul as jax_mm
from jatsr_tpu.ops.quant import quantize_params_static as jax_quantize
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DenseDiT, DiT, rope_cos_sin
from jatsr_torch.models.from_jax import (dense_tree_from_module,
                                         random_dense_params)
from jatsr_torch.ops.attention import gqa_attention_flash_qkv
from jatsr_torch.ops.int8_matmul import int8_dense_gelu_quant
from jatsr_torch.ops.prologue import (_prologue_plain,
                                      int8_norm_mod_dense_gelu_quant,
                                      int8_norm_mod_dot)
from jatsr_torch.ops.quant import quantize_params_static

from test_torch_dit import _assert_close, _inputs
from test_torch_int8_matmul import assert_codes_close
from torch_parity import C, Spy, narrow_cfg, to_numpy_tree

BF16 = jnp.bfloat16


def _bf16_tree(dense):
    """The dense tree with every leaf in bf16, as a JAX model with
    ``param_dtype="bfloat16"`` holds it."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, BF16), dense)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---- 1. bf16 parameters -----------------------------------------------------

@pytest.mark.parametrize("knobs", [
    dict(matmul_precision="bf16", attention_impl="flash"),
    dict(matmul_precision="int8", int8_impl="fused", attention_impl="flash"),
], ids=["bf16", "int8"])
def test_dense_dit_with_bf16_parameters_matches_jax(knobs, monkeypatch):
    """``bench.py --bf16`` and ``--precision int8`` at tiny width: every
    parameter the JAX model stores in ``param_dtype`` is a bf16
    ``nn.Parameter``, both sides reach the split flash kernel (B11), the
    outputs agree, and the tree round trip is bit-exact."""
    spies = [Spy(monkeypatch, "gqa_attention_flash", m) for m in (jattn,
                                                                 None)]
    kw = dict(param_dtype="bfloat16", **knobs)
    tcfg = dataclasses.replace(get_preset("tiny").model, **kw)
    jtree = _bf16_tree(random_dense_params(tcfg, 21))
    tree = to_numpy_tree(jtree)
    model = DenseDiT(tcfg, tree, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    back, want_tree = _flat(dense_tree_from_module(model)), _flat(jtree)
    assert back.keys() == want_tree.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, want_tree[k], err_msg=k)
    rng = np.random.default_rng(22)
    x, c = (rng.standard_normal((2, 45 * 4, 1024), dtype=np.float32)
            for _ in range(2))
    t = np.array([0.3, 0.8], np.float32)
    jcfg = dataclasses.replace(jax_get_preset("tiny").model, **kw)
    want = np.asarray(JaxDiT(jcfg).apply({"params": jtree}, x, t, c))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, c))).numpy()
    # B11 on each side (the JAX block scan may trace its call once).
    assert spies[0].calls and len(spies[1].calls) == 2
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, atol=2e-2 * scale)


@pytest.mark.parametrize("knobs", [{}, dict(fused_prologue=True,
                                            align_n=True)],
                         ids=["no_prologue", "prologue"])
def test_int8_dit_from_a_bf16_tree_matches_jax(knobs):
    """The int8 DiT ignores ``param_dtype`` but takes the tree as it comes:
    from a bf16 tree (the JAX model's with ``param_dtype="bfloat16"``,
    quantized by the JAX package) it gives ``DiT.apply``'s numbers."""
    kw = dict(param_dtype="bfloat16", **knobs)
    jcfg = narrow_cfg(jax_get_preset, "rms", **kw)
    tcfg = narrow_cfg(get_preset, "rms", **kw)
    jmodel = JaxDiT(jcfg)
    z = jnp.zeros((1, 8, C), jnp.float32)
    shape = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, jnp.zeros((1,)), z)["params"])
    jparams = jax_quantize(_bf16_tree(random_dense_params(tcfg, 23)), shape)
    tree = to_numpy_tree(jparams)
    assert tree["t_mlp1"]["kernel"].dtype.name == "bfloat16"
    assert tree["blocks"]["mlp_in"]["bias"].dtype.name == "bfloat16"
    tmodel = DiT(tcfg, tree, device="cpu")
    x_t, t, x_c = _inputs(seed=24)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    assert np.abs(np.asarray(want)).mean() > 0.05
    _assert_close(got.numpy(), np.asarray(want))


# ---- 2. the fp32 modes' plain versions against the JAX kernels --------------

B, NP, H, N = 2, 16, 128, 256


def _prologue_inputs(seed, n=N):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((B, NP, H)) + 0.3).astype(np.float32)
    sc, sh = (np.asarray(jnp.asarray(0.5 * rng.standard_normal((B, H)),
                                     BF16), np.float32) for _ in range(2))
    w_q = rng.integers(-127, 128, (H, n), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, n)) / (127 * np.sqrt(H))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal((1, n))).astype(np.float32)
    return x, sc, sh, w_q, w_s, b


def _jax_codes(x, sc, sh, norm):
    """The JAX kernel's own prologue on fp32 rows: ``_norm_mod``, then its
    row quant (the floored scale divides)."""
    y = jnp.stack([jax_mm._norm_mod(jnp.asarray(x[i]), jnp.asarray(sc[i:i + 1]),
                                    jnp.asarray(sh[i:i + 1]), norm=norm)
                   for i in range(B)]).reshape(B * NP, H)
    s = jnp.maximum(jnp.max(jnp.abs(y), axis=1, keepdims=True)
                    * jax_mm._INV127, 1e-12)
    return np.asarray(jnp.round(y / s).astype(jnp.int8)), np.asarray(s)


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norm_mod_dot_fp32_matches_jax(norm):
    """B3's fp32 mode: an fp32 residual stream in, fp32 qkv out."""
    x, sc, sh, w_q, w_s, b = _prologue_inputs(31)
    want = np.asarray(jax_mm.int8_norm_mod_dot(
        *map(jnp.asarray, (x, sc, sh, w_q, w_s, b)), norm=norm,
        out_dtype=jnp.float32, interpret=True))
    assert want.dtype == np.float32
    got = int8_norm_mod_dot(*map(torch.from_numpy, (x, sc, sh, w_q, w_s, b)),
                            norm=norm, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (B, NP, N)
    codes, s = _prologue_plain(torch.from_numpy(x), torch.from_numpy(sc),
                               torch.from_numpy(sh), norm)
    want_codes, want_s = _jax_codes(x, sc, sh, norm)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norm_mod_dense_gelu_quant_fp32_matches_jax(norm):
    """B1's fp32 mode: an fp32 residual stream in, codes and scales out."""
    x, sc, sh, w_q, w_s, b = _prologue_inputs(32, n=4 * H)
    want_q, want_s = jax_mm.int8_norm_mod_dense_gelu_quant(
        *map(jnp.asarray, (x, sc, sh, w_q, w_s, b)), norm=norm,
        interpret=True)
    got_q, got_s = int8_norm_mod_dense_gelu_quant(
        *map(torch.from_numpy, (x, sc, sh, w_q, w_s, b)), norm=norm)
    assert got_q.shape == (B, NP, 4 * H) and got_s.shape == (B, NP, 1)
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


@pytest.mark.parametrize("M,K,n", [(48, 512, 128), (40, 128, 512)],
                         ids=["patch_embed", "mlp_in"])
def test_dense_gelu_quant_fp32_matches_jax(M, K, n):
    """B5's fp32 mode: fp32 rows (the patch embed's and, without the
    prologue, mlp_in's at dtype="float32") quantised as fp32 values."""
    rng = np.random.default_rng(33 + K)
    a = rng.standard_normal((M, K), dtype=np.float32)
    w_q = rng.integers(-127, 128, (K, n), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, n)) / (127 * np.sqrt(K))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal((1, n))).astype(np.float32)
    want_q, want_s = jax_mm.int8_dense_gelu_quant(
        *map(jnp.asarray, (a, w_q, w_s, b)), interpret=True)
    got_q, got_s = int8_dense_gelu_quant(*map(torch.from_numpy,
                                              (a, w_q, w_s, b)))
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


@pytest.mark.parametrize("hq,hkv,D,n,n_valid", [(4, 2, 32, 40, 33),
                                                (4, 1, 64, 90, 0)])
def test_flash_qkv_fp32_matches_jax(hq, hkv, D, n, n_valid):
    """B2's fp32 mode: an fp32 qkv in (RoPE, the scaled scores, exp2, the
    sums and the value product in fp32), fp32 out; keys masked past
    ``n_valid``."""
    rng = np.random.default_rng(34 + D)
    qkv = rng.standard_normal((2, n, (hq + 2 * hkv) * D), dtype=np.float32)
    cos, sin = (t.numpy() for t in rope_cos_sin(n, D))
    want = np.asarray(jattn.gqa_attention_flash_qkv(
        jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin), hq, hkv,
        interpret=True, n_valid=n_valid))
    assert want.dtype == np.float32
    got = gqa_attention_flash_qkv(*map(torch.from_numpy, (qkv, cos, sin)),
                                  hq, hkv, n_valid=n_valid)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---- 3. the fp32 models -----------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(fused_prologue=True, align_n=True),
                                   {}], ids=["prologue", "no_prologue"])
def test_int8_dit_at_fp32_matches_jax(knobs, monkeypatch):
    """``bench.py``'s default DiT at dtype="float32" (B3, B2, B4, B1 a
    block, B5 for the patch embed, all in fp32 mode) and the same without
    the fused prologue (B2, B5 for the patch embed and mlp_in): the
    kernels each side reaches take fp32 and the outputs agree."""
    kw = dict(dtype="float32", **knobs)
    jcfg = narrow_cfg(jax_get_preset, "rms", **kw)
    tcfg = narrow_cfg(get_preset, "rms", **kw)
    dense = random_dense_params(tcfg, 35)
    jmodel = JaxDiT(jcfg)
    z = jnp.zeros((1, 8, C), jnp.float32)
    shape = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, z, jnp.zeros((1,)), z)["params"])
    jparams = jax_quantize(jax.tree_util.tree_map(jnp.asarray, dense), shape)
    tmodel = DiT(tcfg, quantize_params_static(dense, tcfg), device="cpu")
    names = ("gqa_attention_flash_qkv", "int8_dense_gelu_quant",
             "int8_norm_mod_dot", "int8_norm_mod_dense_gelu_quant",
             "int8_matmul_fused")
    spies = {n: Spy(monkeypatch, n) for n in names}
    x_t, t, x_c = _inputs(seed=36)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x_t), jnp.asarray(t),
                        jnp.asarray(x_c))
    got = tmodel(torch.from_numpy(x_t), torch.from_numpy(t),
                 torch.from_numpy(x_c))
    reached = {n for n, s in spies.items() if s.calls}
    assert reached == (set(names) if knobs else
                       {"gqa_attention_flash_qkv", "int8_dense_gelu_quant"})
    assert {s.calls[0][0][0].dtype for s in spies.values() if s.calls} == {
        torch.float32}
    assert np.abs(np.asarray(want)).mean() > 0.05
    _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_dense_dit_at_fp32_matches_jax(precision):
    """``DenseDiT`` at dtype="float32" with the einsum attention (the model
    ``tools/import_reference.py`` builds; no preset sets
    ``attention_impl``): fp32 products, the dynamic int8 ones on fp32
    activations."""
    kw = dict(dtype="float32", matmul_precision=precision,
              attention_impl="xla")
    tcfg = dataclasses.replace(get_preset("tiny").model, **kw)
    dense = random_dense_params(tcfg, 37)
    rng = np.random.default_rng(38)
    x, c = (rng.standard_normal((2, 33 * 4, 1024), dtype=np.float32)
            for _ in range(2))
    t = np.array([0.2, 0.9], np.float32)
    jcfg = dataclasses.replace(jax_get_preset("tiny").model, **kw)
    want = np.asarray(JaxDiT(jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, dense)}, x, t, c))
    with torch.no_grad():
        got = DenseDiT(tcfg, dense, device="cpu")(
            *map(torch.from_numpy, (x, t, c))).numpy()
    assert np.abs(want).mean() > 0.05
    _assert_close(got, want)


@pytest.mark.parametrize("knob", [dict(dtype="float32"),
                                  dict(param_dtype="bfloat16")])
def test_fp32_and_bf16_parameter_models_serve_and_train(knob):
    """Both serve (the einsum attention) and run their training forward and
    backward (B10's plain versions), the gradients in the parameters' dtype;
    ``tests/test_torch_train_f32.py`` holds their steps against JAX."""
    cfg = dataclasses.replace(get_preset("tiny").model, attention_impl="xla",
                              **knob)
    model = DenseDiT(cfg, random_dense_params(cfg, 40), device="cpu")
    x = torch.from_numpy(np.random.default_rng(40).standard_normal(
        (1, 8, 1024), dtype=np.float32))
    with torch.no_grad():
        assert model(x, torch.zeros(1), x).shape == x.shape
    out = model(x, torch.zeros(1), x, deterministic=False, layer_seeds=[0, 1])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    (out ** 2).mean().backward()
    for p in model.parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype
        assert torch.isfinite(p.grad).all()


# ---- 4. bf16 scores in training ---------------------------------------------

def test_train_step_with_bf16_scores_matches_jax():
    """Two whole steps of the tiny model on the einsum path with
    ``scores_dtype="bfloat16"`` (dropout 0), fed the JAX step's draws: the
    metrics and the updated parameters as ``test_train_steps_match_jax``
    bounds them."""
    from jatsr_tpu.configs import LossConfig as JaxLossConfig
    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig
    from jatsr_tpu.train import create_train_state as jax_create_state
    from jatsr_tpu.train import make_train_step as jax_train_step
    from jatsr_tpu.train.step import Normalizer as JaxNormalizer

    from jatsr_torch.configs import LossConfig, TrainConfig
    from jatsr_torch.train import create_train_state, make_train_step
    from jatsr_torch.train.step import Normalizer

    import test_torch_train_step as ts

    kw = dict(batch_size=ts.B, lr=1e-3, warmup_steps=1,
              cfg_dropout_prob=0.5, condition_noise_ratio=0.05)
    knobs = dict(scores_dtype="bfloat16", train_attention_impl="xla")
    rng = np.random.default_rng(41)
    hr, lr = (rng.standard_normal((ts.B, ts.T, ts.C), dtype=np.float32)
              for _ in range(2))
    stats = ts._stats(rng)
    tcfg = dataclasses.replace(get_preset("tiny").model, **knobs)
    assert tcfg.dropout == 0.0
    dense = random_dense_params(tcfg, 42)
    jmodel = JaxDiT(dataclasses.replace(jax_get_preset("tiny").model, **knobs))
    jstate = jax_create_state(jmodel, JaxTrainConfig(**kw), total_steps=100,
                              sample_batch=(hr, lr))
    params = jax.tree_util.tree_map(jnp.asarray, dense)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jstep = jax.jit(jax_train_step(JaxLossConfig(), JaxTrainConfig(**kw),
                                   JaxNormalizer(*stats)))
    state = create_train_state(DenseDiT(tcfg, dense, device="cpu"),
                               TrainConfig(**kw), 100, (hr, lr), device="cpu")
    step = make_train_step(LossConfig(), TrainConfig(**kw),
                           Normalizer(*stats, device="cpu"))
    for s in range(2):
        draws = ts._jax_draws(jstate, s, hr.shape)
        jstate, jm = jstep(jstate, hr, lr)
        state, m = step(state, torch.from_numpy(hr), torch.from_numpy(lr),
                        draws=draws)
        for k in set(jm) - {"cond_noise_std", "snr_db", "pred_mean"}:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-2,
                                       err_msg=k)
    lr1 = 1e-3
    got, want = (_flat(t) for t in (dense_tree_from_module(state.model),
                                    jstate.params))
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * lr1 * 1.01, k
        assert d.mean() <= 0.02 * lr1, k
