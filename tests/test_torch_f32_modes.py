"""The fp32 modes of B11, B15, B16, B12, B13 and B2's int8 value product,
and the served DiT at ``dtype="float32"`` on every branch, against the JAX
package on the CPU.

Each mode's plain version (what the port's wrapper runs on a CPU tensor)
against the JAX kernel in interpret mode, on the same fp32 inputs made with
numpy from a seed:

- B11, B15, B16 at N 45 (B11 pads 3 zero keys) and N 130 (B15 and B16 pad
  past 128), 4/2 heads, head dims 16 and 64, and a B11 case whose real
  scores are all negative, so that its zero keys hold every row's max:
  rtol = atol = 1e-5 (fp32 products and sums in another order; exp and
  exp2 in each framework's own fp32 form).
- B12: the codes and scales of its row quant, read back through an
  identity out projection (``out = o_q * so``: each code is ``round(out /
  (max|out| / 127))``), the codes equal but for at most 0.5 % off by one
  (``assert_codes_close``'s bound: a head output one ulp apart can move a
  code), the scales within rtol 1e-5 (a row's max |o| is a sum of w v
  whose terms cancel, taken in another order, then read back through one
  more rounding: measured 1.4e-6, past ``assert_codes_close``'s 1e-6);
  then the outputs with a real projection within atol = rtol = 2e-3, its
  bf16 test's bound (``tests/test_torch_attention.py``).
- B13 on fp32 rows (the reciprocal row quant reads fp32; bf16 out): the
  bounds of ``tests/test_torch_int8_matmul.py::test_int8_mlp_matches_jax``
  (at most 0.1 % of the outputs differ, each within 0.02 + 0.02 relative).
- B2 with ``int8_qk`` on an fp32 qkv: the bounds of
  ``tests/test_torch_attention_int8_qk.py`` (atol = rtol = 1e-2: a code of
  e * 127 on a rounding boundary can flip by one).

The narrow int8 ``DiT`` at fp32 on each of the seven branches whose kernel
gained its fp32 mode (q/k/v apart, no flash-QKV, the fused out projection,
the whole MLP, the per-q-head and per-kv-head attention, the int8 value
product) and ``DenseDiT`` at fp32 with each attention kernel, against
``DiT.apply``: within ``test_torch_dit.py``'s bounds (``_assert_close``),
each side reaching the branch's kernel with fp32 inputs.  Then the slice as
a whole: ``FlowSampler`` (4 Euler steps, CFG 2.0) on the narrow third path
at fp32 (``--flash-out --fused-mlp-impl full --int8-impl pallas``) against
JAX's sampler on the same weights, noise and conditioning, within the
bounds of ``tests/test_torch_pipeline.py``'s sampler tests (max abs 5e-2,
relative L2 < 5e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import SamplerConfig as JaxSamplerConfig
from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.models.dit import adaln_tables as jax_adaln_tables
from jatsr_tpu.ops import attention as jattn
from jatsr_tpu.ops import int8_matmul as jax_mm
from jatsr_tpu.sampling import FlowSampler as JaxFlowSampler
from jatsr_torch.configs import SamplerConfig, get_preset
from jatsr_torch.models.dit import DenseDiT, adaln_tables, rope_cos_sin
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.ops.attention import (gqa_attention, gqa_attention_flash,
                                       gqa_attention_flash_out,
                                       gqa_attention_flash_qkv,
                                       gqa_attention_grouped)
from jatsr_torch.ops.int8_matmul import int8_mlp
from jatsr_torch.sampling import FlowSampler

from test_torch_dit import _assert_close, _inputs
from test_torch_int8_matmul import _mlp_inputs, assert_codes_close
from test_torch_pipeline import _assert_close as _assert_sampler_close
from torch_parity import Spy, build_pair

HQ, HKV = 4, 2


def _split_inputs(seed, N, D, negative=False):
    """fp32 q [2, N, HQ, D], k/v [2, N, HKV, D]; ``negative``: q <= 0 and
    k >= 0, so that every real score is negative (B11's zero keys, which
    score 0, then hold each row's max)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, N, h, D), dtype=np.float32)
               for h in (HQ, HKV, HKV))
    if negative:
        q, k = -np.abs(q), np.abs(k)
    return q, k, v


@pytest.mark.parametrize("N,D", [(45, 16), (45, 64), (130, 16), (130, 64)])
def test_flash_split_fp32_matches_jax(N, D):
    q, k, v = (x.reshape(2, N, -1) for x in _split_inputs(N + D, N, D))
    want = np.asarray(jattn.gqa_attention_flash(
        *map(jnp.asarray, (q, k, v)), HQ, HKV, interpret=True))
    got = gqa_attention_flash(*map(torch.from_numpy, (q, k, v)), HQ, HKV)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_split_fp32_zero_keys_hold_the_max_matches_jax():
    """N 45 pads 3 zero keys; every real score is below them."""
    q, k, v = (x.reshape(2, 45, -1) for x in _split_inputs(7, 45, 16, True))
    s = np.einsum("bnhd,bmhd->bhnm", q.reshape(2, 45, HKV, -1, 16)[:, :, :, 0],
                  k.reshape(2, 45, HKV, 16))
    assert (s < 0).all()
    want = np.asarray(jattn.gqa_attention_flash(
        *map(jnp.asarray, (q, k, v)), HQ, HKV, interpret=True))
    got = gqa_attention_flash(*map(torch.from_numpy, (q, k, v)), HQ, HKV)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,D", [(45, 16), (45, 64), (130, 16), (130, 64)])
def test_per_head_attention_fp32_matches_jax(N, D):
    """B15 (a program per q-head) and B16 (per kv-head), one plain
    version."""
    q, k, v = _split_inputs(2 * N + D, N, D)
    args = tuple(map(jnp.asarray, (q, k, v)))
    for jfn, fn in ((jattn.gqa_attention, gqa_attention),
                    (jattn.gqa_attention_grouped, gqa_attention_grouped)):
        want = np.asarray(jfn(*args, interpret=True))
        got = fn(*map(torch.from_numpy, (q, k, v)))
        assert want.dtype == np.float32 and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _qkv(seed, N, D, hq=HQ, hkv=HKV):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((2, N, (hq + 2 * hkv) * D), dtype=np.float32)
    cos, sin = (np.asarray(t) for t in rope_cos_sin(N, D))
    return qkv, cos, sin


def _flash_out_both(qkv, cos, sin, wo_q, wo_s, bo, n_valid):
    want = np.asarray(jattn.gqa_attention_flash_out(
        *map(jnp.asarray, (qkv, cos, sin, wo_q, wo_s, bo)), HQ, HKV,
        interpret=True, n_valid=n_valid))
    got = gqa_attention_flash_out(
        *map(torch.from_numpy, (qkv, cos, sin, wo_q, wo_s, bo)), HQ, HKV,
        n_valid=n_valid)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    return got.numpy(), want


def _codes(out):
    """The codes and row scales of an identity out projection's output
    (``o_q * so``): the row's largest code is 127."""
    so = np.abs(out).max(axis=-1, keepdims=True) / np.float32(127)
    return np.round(out / so).astype(np.int8), so


@pytest.mark.parametrize("D,n_valid", [(32, 77), (64, 0)])
def test_flash_out_fp32_matches_jax(D, n_valid):
    qkv, cos, sin = _qkv(60 + D, 90, D)
    K = HQ * D
    eye = (np.eye(K, dtype=np.int8), np.ones((1, K), np.float32),
           np.zeros((1, K), np.float32))
    got, want = _flash_out_both(qkv, cos, sin, *eye, n_valid)
    (got_q, got_s), (want_q, want_s) = _codes(got), _codes(want)
    assert np.abs(got_q).max() == 127
    assert_codes_close(got_q, want_s, want_q, want_s)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    rng = np.random.default_rng(61 + D)
    wo_q, wo_s = (np.asarray(t) for t in jax_mm.quantize_cols(jnp.asarray(
        rng.standard_normal((K, 128), dtype=np.float32) * 0.05)))
    bo = (0.1 * rng.standard_normal((1, 128))).astype(np.float32)
    got, want = _flash_out_both(qkv, cos, sin, wo_q, wo_s, bo, n_valid)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("N1,gelu_impl", [(512, "tanh"), (2560, "erf")])
def test_int8_mlp_fp32_matches_jax(N1, gelu_impl):
    """One slab and two, on fp32 rows: bf16 out on both sides."""
    args = _mlp_inputs(seed=62, N1=N1)
    want = np.asarray(jax_mm.int8_mlp(
        *map(jnp.asarray, args), interpret=True, gelu_impl=gelu_impl))
    got = int8_mlp(*map(torch.from_numpy, args), gelu_impl=gelu_impl)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    got, want = got.float().numpy(), want.astype(np.float32)
    assert (got != want).mean() <= 1e-3, (got != want).mean()
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0.02)


@pytest.mark.parametrize("D,n_valid", [(16, 37), (32, 0), (48, 37),
                                       (64, 37)])
def test_flash_qkv_int8_qk_fp32_matches_jax(D, n_valid):
    """N 40 with keys masked past 37 (a padded row holding every v
    column's max) or none; 48 is no multiple of 16 (the card pads its
    codes)."""
    qkv, cos, sin = _qkv(63 + D, 40, D)
    qkv[:, 38, (HQ + HKV) * D:] = 5.0
    want = np.asarray(jattn.gqa_attention_flash_qkv(
        *map(jnp.asarray, (qkv, cos, sin)), HQ, HKV, interpret=True,
        n_valid=n_valid, int8_qk=True))
    got = gqa_attention_flash_qkv(*map(torch.from_numpy, (qkv, cos, sin)),
                                  HQ, HKV, n_valid=n_valid, int8_qk=True)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=1e-2)


# ---- the served DiT at fp32 -------------------------------------------------

# The knobs of each branch and the kernel it reaches in each framework (the
# JAX model imports its kernels at call time, so a patched attribute of its
# ops module sees the call; the port's through models/dit.py's names).
BRANCHES = {
    "B11": (dict(fused_qkv=False), "gqa_attention_flash", jattn),
    "B11_no_flash_qkv": (dict(flash_qkv=False), "gqa_attention_flash",
                         jattn),
    "B12": (dict(flash_fused_out=True), "gqa_attention_flash_out", jattn),
    "B13": (dict(fused_mlp_impl="full"), "int8_mlp", jax_mm),
    "B15": (dict(attention_impl="pallas"), "gqa_attention", jattn),
    "B16": (dict(attention_impl="pallas2"), "gqa_attention_grouped", jattn),
    "int8_qk": (dict(flash_int8_qk=True), "gqa_attention_flash_qkv", jattn),
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_int8_dit_at_fp32_on_every_branch_matches_jax(name, monkeypatch):
    knobs, kernel, jmodule = BRANCHES[name]
    jmodel, jparams, tmodel, _ = build_pair("rms", seed=64, dtype="float32",
                                            **knobs)
    spies = (Spy(monkeypatch, kernel, jmodule), Spy(monkeypatch, kernel))
    x_t, t, x_c = _inputs(seed=65)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x_t),
                                   jnp.asarray(t), jnp.asarray(x_c)))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x_t, t, x_c))).numpy()
    assert all(s.calls for s in spies)
    assert spies[1].calls[0][0][0].dtype == torch.float32
    if name == "int8_qk":
        assert all(s.calls[0][1]["int8_qk"] for s in spies)
    assert np.abs(want).mean() > 0.05
    _assert_close(got, want)


@pytest.mark.parametrize("impl,kernel", [("flash", "gqa_attention_flash"),
                                         ("pallas", "gqa_attention"),
                                         ("pallas2", "gqa_attention_grouped")])
def test_dense_dit_at_fp32_with_attention_kernels_matches_jax(impl, kernel,
                                                              monkeypatch):
    kw = dict(dtype="float32", matmul_precision="bf16", attention_impl=impl)
    tcfg = dataclasses.replace(get_preset("tiny").model, **kw)
    dense = random_dense_params(tcfg, 66)
    rng = np.random.default_rng(67)
    x, c = (rng.standard_normal((2, 33 * 4, 1024), dtype=np.float32)
            for _ in range(2))
    t = np.array([0.2, 0.9], np.float32)
    spies = (Spy(monkeypatch, kernel, jattn), Spy(monkeypatch, kernel))
    jcfg = dataclasses.replace(jax_get_preset("tiny").model, **kw)
    want = np.asarray(JaxDiT(jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, dense)}, x, t, c))
    with torch.no_grad():
        got = DenseDiT(tcfg, dense, device="cpu")(
            *map(torch.from_numpy, (x, t, c))).numpy()
    assert all(s.calls for s in spies)
    assert spies[1].calls[0][0][0].dtype == torch.float32
    assert np.abs(want).mean() > 0.05
    _assert_close(got, want)


def test_flow_sampler_on_the_fp32_third_path_matches_jax():
    """``bench.py --flash-out --fused-mlp-impl full --int8-impl pallas``'s
    DiT at dtype="float32" (B14 writing fp32, B12 and B13 in fp32 mode) on
    the narrow config, under the doubled-CFG sampler with hoisted tables."""
    jmodel, jparams, tmodel, _ = build_pair(
        "layer", seed=68, dtype="float32", fused_prologue=True, align_n=True,
        flash_fused_out=True, fused_mlp_impl="full", int8_impl="pallas")
    rng = np.random.default_rng(69)
    cond, z0 = (rng.standard_normal((2, 64, 64), dtype=np.float32)
                for _ in range(2))
    want = JaxFlowSampler(
        lambda p, z, t, c, mod=None: jmodel.apply({"params": p}, z, t, c,
                                                  adaln_mod=mod),
        JaxSamplerConfig(num_steps=4), params=jparams,
        adaln_fn=lambda p, tv: jax_adaln_tables(jmodel.cfg, p, tv))(
            jax.random.PRNGKey(0), jnp.asarray(cond), 4, 2.0,
            z0=jnp.asarray(z0))
    sampler = FlowSampler(
        lambda z, t, c, mod=None: tmodel(z, t, c, adaln_mod=mod),
        SamplerConfig(num_steps=4), adaln_fn=lambda tv: adaln_tables(tmodel, tv),
        device="cpu")
    with torch.no_grad():
        got = sampler(torch.from_numpy(cond), 4, 2.0, z0=torch.from_numpy(z0))
    assert got.dtype == torch.float32 and got.shape == cond.shape
    _assert_sampler_close(got.numpy(), np.asarray(want), atol=5e-2)
