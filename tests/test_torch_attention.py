"""The port's flash-QKV attention against the JAX kernel.

The JAX side runs ``gqa_attention_flash_qkv`` in interpret mode, as the
JAX package's own tests do on the CPU; the port's wrapper takes its plain
PyTorch version for CPU tensors.  Inputs are made with numpy from a seed
and handed to both.

Tolerances: fp32 at 2e-5, the JAX package's own flash-kernel tolerance
(``tests/test_pallas_attention.py``): only summation order differs.  bf16
at 2e-2: both sides round at the same points, but bf16 RoPE products and
the bf16 softmax weights flip by one bf16 ulp (2^-8 relative) where the two
frameworks' exp2 or summation differ in the last fp32 bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.models.dit import rope_cos_sin
from jatsr_tpu.ops.attention import gqa_attention_flash_qkv as jax_flash_qkv
from jatsr_torch.ops.attention import gqa_attention_flash_qkv

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
