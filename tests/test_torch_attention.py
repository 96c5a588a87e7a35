"""The port's flash-QKV attention, alone and with the fused int8 out
projection, against the JAX kernels.

The JAX side runs ``gqa_attention_flash_qkv`` and ``gqa_attention_flash_out``
in interpret mode, as the JAX package's own tests do on the CPU; the port's wrapper takes its plain
PyTorch version for CPU tensors.  Inputs are made with numpy from a seed
and handed to both.

Tolerances: fp32 at 2e-5, the JAX package's own flash-kernel tolerance
(``tests/test_pallas_attention.py``): only summation order differs.  bf16
at 2e-2: both sides round at the same points, but bf16 RoPE products and
the bf16 softmax weights flip by one bf16 ulp (2^-8 relative) where the two
frameworks' exp2 or summation differ in the last fp32 bit.

The fused out projection: atol = rtol = 2e-3, the JAX package's own bound
for the kernel against its unfused form, in fp32 and in bf16.  Its output
passes through a row quantisation and an exact int8 product, so a weight or
head output that moves by one ulp rarely moves a code; measured max 6.6e-4
(fp32) and one bf16 ulp, 1.95e-3, on 0.2-0.3 % of the outputs (bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.models.dit import rope_cos_sin
from jatsr_tpu.ops.attention import gqa_attention_flash_out as jax_flash_out
from jatsr_tpu.ops.attention import gqa_attention_flash_qkv as jax_flash_qkv
from jatsr_tpu.ops.int8_matmul import quantize_cols
from jatsr_torch.ops.attention import (gqa_attention_flash_out,
                                       gqa_attention_flash_qkv)

B, N, HQ, HKV, D = 2, 90, 8, 2, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, (HQ + 2 * HKV) * D), dtype=np.float32)
    cos, sin = (np.asarray(a) for a in rope_cos_sin(N, D))
    return qkv, cos, sin


@pytest.mark.parametrize("dtype,tol,n_valid", [
    ("float32", 2e-5, 0),
    ("bfloat16", 2e-2, 0),
    ("float32", 2e-5, 77),
    ("bfloat16", 2e-2, 77),
])
def test_flash_qkv_matches_jax(dtype, tol, n_valid):
    qkv, cos, sin = _inputs(seed=3)
    want = jax_flash_qkv(jnp.asarray(qkv, dtype), jnp.asarray(cos),
                         jnp.asarray(sin), HQ, HKV, interpret=True,
                         n_valid=n_valid)
    got = gqa_attention_flash_qkv(
        torch.from_numpy(qkv).to(getattr(torch, dtype)),
        torch.from_numpy(cos), torch.from_numpy(sin), HQ, HKV,
        n_valid=n_valid)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, N, HQ * D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_flash_qkv_matches_jax_at_head_dim_16_past_768_keys(dtype, tol):
    """D = 16 (the JAX kernel tests' smallest head dim) at N = 864, where
    the port's kernel holds eight 128-key chunks a row group; keys masked
    past 850."""
    n, d, n_valid = 864, 16, 850
    rng = np.random.default_rng(6)
    qkv = rng.standard_normal((B, n, (HQ + 2 * HKV) * d), dtype=np.float32)
    cos, sin = (np.asarray(a) for a in rope_cos_sin(n, d))
    want = jax_flash_qkv(jnp.asarray(qkv, dtype), jnp.asarray(cos),
                         jnp.asarray(sin), HQ, HKV, interpret=True,
                         n_valid=n_valid)
    got = gqa_attention_flash_qkv(
        torch.from_numpy(qkv).to(getattr(torch, dtype)),
        torch.from_numpy(cos), torch.from_numpy(sin), HQ, HKV,
        n_valid=n_valid)
    assert got.shape == (B, n, HQ * d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_qkv_key_mask_ignores_masked_keys():
    """Keys at positions >= n_valid carry no weight: changing them leaves
    every output row unchanged."""
    qkv, cos, sin = _inputs(seed=4)
    other = qkv.copy()
    other[:, 60:, HQ * D:] = 100.0  # k and v heads of the masked keys
    a, b = (gqa_attention_flash_qkv(torch.from_numpy(x), torch.from_numpy(cos),
                                    torch.from_numpy(sin), HQ, HKV, n_valid=60)
            for x in (qkv, other))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_flash_qkv_rejects_bad_shapes():
    qkv, cos, sin = _inputs(seed=5)
    with pytest.raises(ValueError):
        gqa_attention_flash_qkv(torch.from_numpy(qkv[..., :-1]),
                                torch.from_numpy(cos), torch.from_numpy(sin),
                                HQ, HKV)
    with pytest.raises(ValueError):
        gqa_attention_flash_qkv(torch.from_numpy(qkv), torch.from_numpy(cos),
                                torch.from_numpy(sin), HQ, HKV, n_valid=N + 1)


def _out_inputs(seed, D, H, n=N):
    """qkv [2, n, 12 D], the RoPE tables, and an int8 [8 D, H] out
    projection with a non-zero bias (the JAX package's test draws)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, n, (HQ + 2 * HKV) * D), dtype=np.float32)
    cos, sin = (np.array(a) for a in rope_cos_sin(n, D))
    wo_q, wo_s = (np.array(a) for a in quantize_cols(jnp.asarray(
        rng.standard_normal((HQ * D, H), dtype=np.float32) * 0.05)))
    bo = (0.1 * rng.standard_normal((1, H))).astype(np.float32)
    return qkv, cos, sin, wo_q, wo_s, bo


@pytest.mark.parametrize("D,H,n,n_valid", [(32, 128, N, 0),
                                           (64, 256, N, 77),
                                           (16, 128, 864, 850)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_out_matches_jax(D, H, n, n_valid, dtype):
    """The JAX test's geometry (D 32, H 128), D 64 with keys masked past 77
    of 90, and D 16 at N = 864 (eight 128-key chunks in the port's kernel)
    with keys masked past 850."""
    qkv, cos, sin, wo_q, wo_s, bo = _out_inputs(10 + D, D, H, n)
    want = jax_flash_out(jnp.asarray(qkv, dtype), jnp.asarray(cos),
                         jnp.asarray(sin), jnp.asarray(wo_q),
                         jnp.asarray(wo_s), jnp.asarray(bo), HQ, HKV,
                         interpret=True, n_valid=n_valid)
    got = gqa_attention_flash_out(
        torch.from_numpy(qkv).to(getattr(torch, dtype)),
        *map(torch.from_numpy, (cos, sin, wo_q, wo_s, bo)), HQ, HKV,
        n_valid=n_valid)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, n, H)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-3, rtol=2e-3)


def test_flash_out_key_mask_and_shape_checks():
    qkv, cos, sin, wo_q, wo_s, bo = (torch.from_numpy(a)
                                     for a in _out_inputs(5, 32, 128))
    other = qkv.clone()
    other[:, 60:, HQ * 32:] = 100.0  # k and v heads of the masked keys
    a, b = (gqa_attention_flash_out(x, cos, sin, wo_q, wo_s, bo, HQ, HKV,
                                    n_valid=60) for x in (qkv, other))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    n0 = gqa_attention_flash_out.launches
    with pytest.raises(ValueError):
        gqa_attention_flash_out(qkv, cos, sin, wo_q[:200], wo_s, bo, HQ, HKV)
    with pytest.raises(ValueError):
        gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, HQ, HKV,
                                n_valid=N + 1)
    assert gqa_attention_flash_out.launches == n0
