"""The port's int8 serving products against the JAX package.

``int8_dense_gelu_quant``: the JAX kernel in interpret mode against the
port's plain PyTorch version.  The int8 product is exact on both sides, so
the codes differ only where the two frameworks' tanh/exp/erf differ in the
last fp32 bit and push a value across a rounding boundary: at most 0.5% of
the codes, each by exactly +-1.  The row scales are max|g| * (1/127) and
agree to rtol 1e-6.

``w8a8_dot``: exact int32 accumulation at K=5120 (where an fp32 sum is not
exact), so the outputs are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops.int8_matmul import int8_dense_gelu_quant as jax_dgq
from jatsr_tpu.ops.quant import w8a8_dot as jax_w8a8_dot
from jatsr_torch.ops.int8_matmul import int8_dense_gelu_quant
from jatsr_torch.ops.quant import QuantDense, w8a8_dot


def _dgq_inputs(seed, M=100, K=256, N=512):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K), dtype=np.float32)
    w_q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, N)) / (127 * np.sqrt(K))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal((1, N))).astype(np.float32)
    return a, w_q, w_s, b


def assert_codes_close(got_q, got_s, want_q, want_s):
    diff = got_q.astype(np.int32) - want_q.astype(np.int32)
    assert np.abs(diff).max() <= 1, np.abs(diff).max()
    assert (diff != 0).mean() <= 0.005, (diff != 0).mean()
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)


@pytest.mark.parametrize("gelu_impl", ["tanh", "erf"])
@pytest.mark.parametrize("fast_epilogue", [True, False])
def test_dense_gelu_quant_matches_jax(gelu_impl, fast_epilogue):
    a, w_q, w_s, b = _dgq_inputs(seed=1)
    want_q, want_s = jax_dgq(jnp.asarray(a, jnp.bfloat16), jnp.asarray(w_q),
                             jnp.asarray(w_s), jnp.asarray(b), interpret=True,
                             gelu_impl=gelu_impl, fast_epilogue=fast_epilogue)
    got_q, got_s = int8_dense_gelu_quant(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(w_q),
        torch.from_numpy(w_s), torch.from_numpy(b), gelu_impl=gelu_impl,
        fast_epilogue=fast_epilogue)
    assert got_q.dtype == torch.int8 and got_q.shape == (100, 512)
    assert got_s.dtype == torch.float32 and got_s.shape == (100, 1)
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


def test_dense_gelu_quant_sigmoid_matches_jax():
    a, w_q, w_s, b = _dgq_inputs(seed=2)
    want_q, want_s = jax_dgq(jnp.asarray(a, jnp.bfloat16), jnp.asarray(w_q),
                             jnp.asarray(w_s), jnp.asarray(b), interpret=True,
                             gelu_impl="sigmoid")
    got_q, got_s = int8_dense_gelu_quant(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(w_q),
        torch.from_numpy(w_s), torch.from_numpy(b), gelu_impl="sigmoid")
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_dot_bit_exact_at_k5120(dtype):
    rng = np.random.default_rng(7)
    M, K, N = 24, 5120, 256
    x = rng.standard_normal((2, M // 2, K), dtype=np.float32)
    w_q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, N)) / 127).astype(np.float32)
    want = jax_w8a8_dot(jnp.asarray(x, dtype), jnp.asarray(w_q),
                        jnp.asarray(w_s))
    got = w8a8_dot(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(w_q), torch.from_numpy(w_s))
    assert got.shape == (2, M // 2, N) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quant_dense_adds_bias_in_output_dtype():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 5, 128), dtype=np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, (128, 64), dtype=np.int8))
    w_s = torch.full((1, 64), 1.0 / (127 * 128 ** 0.5))
    bias = torch.from_numpy(rng.standard_normal(64, dtype=np.float32))
    out = QuantDense(w_q, w_s, bias)(x)
    want = w8a8_dot(x.bfloat16(), w_q, w_s) + bias.bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_dense_gelu_quant_rejects_unaligned_shapes():
    a, w_q, w_s, b = _dgq_inputs(seed=3, N=512)
    with pytest.raises(ValueError):
        int8_dense_gelu_quant(torch.from_numpy(a[:, :200]).bfloat16(),
                              torch.from_numpy(w_q[:200]),
                              torch.from_numpy(w_s), torch.from_numpy(b))
    with pytest.raises(ValueError):
        int8_dense_gelu_quant(torch.from_numpy(a).bfloat16(),
                              torch.from_numpy(w_q), torch.from_numpy(w_s),
                              torch.from_numpy(b), gelu_impl="relu")
